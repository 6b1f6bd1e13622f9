"""K2: the fused SRVGG tail — CUDA kernel wrapper + plain version.

Port of ``upscale_video_tpu/ops/tail_pallas.py:155-319``
(``_tail_chain_kernel`` / ``sr_tail_fused_chain``).  From the conv chain's
bordered buffer ``(N, H+2, W+2, Cf)`` it computes the tail conv
Cf -> 3*s*s + bias in f32, adds the nearest-s skip of the model-domain
input, and writes one of :data:`LAYOUTS`:

- ``"planar"``: uint8 ``(N, H, W, 3*s*s)`` in (i, j, c) order, c fastest,
  RGB — the shuffle-planar contract (``executor._planar_tail_u8``'s output,
  :func:`~upscale_video_tpu_torch.ops.pixel.planar_to_frames`' input);
- ``"frames"``: uint8 ``(N, s*H, s*W, 3)`` RGB;
- ``"model"``: float32 ``(N, s*H, s*W, 3)`` in the BGR model domain.

The u8 layouts quantize with ``clip(round_half_even(v * 255), 0, 255)``
and fold in the BGR -> RGB flip.  :func:`sr_tail_chain` dispatches on the
buffer's device: CPU -> :func:`sr_tail_chain_plain`; CUDA -> the kernel in
``csrc/sr_tail.cu`` or an exception.  ``sr_tail_chain.launches`` counts
kernel launches (one per call).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from upscale_video_tpu_torch.ops.conv_chain import no_tf32, oihw

LAYOUTS = ("planar", "frames", "model")
MAX_CHANNELS = 128


def _check(buf, skip, wmat, bias, scale, layout):
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")
    if buf.ndim != 4 or skip.ndim != 4:
        raise ValueError("buf and skip must be NHWC")
    n, hp, wp, cf = buf.shape
    cout = 3 * scale * scale
    if scale < 1 or cout > MAX_CHANNELS or not 0 < cf <= MAX_CHANNELS:
        raise ValueError(f"scale {scale} / {cf} channels outside the kernel's range")
    if tuple(skip.shape) != (n, hp - 2, wp - 2, 3):
        raise ValueError(f"skip {tuple(skip.shape)} does not match buffer "
                         f"{tuple(buf.shape)} (bordered by one pixel)")
    if tuple(wmat.shape) != (9 * cf, cout) or tuple(bias.shape) != (cout,):
        raise ValueError(f"tail weights {tuple(wmat.shape)}/{tuple(bias.shape)} "
                         f"!= ({9 * cf}, {cout})/({cout},)")


def _planar_order(v: torch.Tensor, s: int) -> torch.Tensor:
    """(N, H, W, 3*s*s) in shuffle order (c, a, b) -> planar (a, b, c')
    with c' = 2 - c (BGR -> RGB)."""
    n, h, w, _ = v.shape
    return (v.reshape(n, h, w, 3, s, s).flip(3)
            .permute(0, 1, 2, 4, 5, 3).reshape(n, h, w, 3 * s * s))


def _shuffle(v: torch.Tensor, s: int) -> torch.Tensor:
    """(N, H, W, 3*s*s) shuffle order -> (N, s*H, s*W, 3) (PixelShuffle
    mode 0: channel c*s*s + a*s + b lands at (s*y + a, s*x + b, c))."""
    n, h, w, _ = v.shape
    return (v.reshape(n, h, w, 3, s, s).permute(0, 1, 4, 2, 5, 3)
            .reshape(n, h * s, w * s, 3))


def quantize_u8(v: torch.Tensor) -> torch.Tensor:
    """``clip(round_half_even(v * 255), 0, 255)`` as uint8."""
    return torch.clamp(torch.round(v * 255.0), 0.0, 255.0).to(torch.uint8)


def sr_tail_chain_plain(buf: torch.Tensor, skip: torch.Tensor,
                        wmat: torch.Tensor, bias: torch.Tensor, scale: int,
                        layout: str = "planar") -> torch.Tensor:
    """Plain PyTorch version of K2: an f32 VALID conv over the bordered
    buffer (= SAME over the frame, since the ring is zero; TF32 off) +
    bias, + the skip repeated s*s times per channel, then the layout."""
    _check(buf, skip, wmat, bias, scale, layout)
    with no_tf32():
        y = F.conv2d(buf.to(torch.float32).permute(0, 3, 1, 2), oihw(wmat))
    y = y.permute(0, 2, 3, 1) + bias.to(torch.float32)
    v = y + skip.to(torch.float32).repeat_interleave(scale * scale, dim=-1)
    if layout == "model":
        return _shuffle(v, scale).contiguous()
    if layout == "planar":
        return quantize_u8(_planar_order(v, scale)).contiguous()
    return quantize_u8(_shuffle(v, scale).flip(-1)).contiguous()


def sr_tail_chain(buf: torch.Tensor, skip: torch.Tensor, wmat: torch.Tensor,
                  bias: torch.Tensor, scale: int,
                  layout: str = "planar") -> torch.Tensor:
    """Fused SRVGG tail over the conv chain's bordered buffer.

    ``buf``: ``(N, H+2, W+2, Cf)`` with a zero ring (``conv3x3_chain(...,
    crop=False)``); ``skip``: ``(N, H, W, 3)`` model-domain input in the
    compute dtype; ``wmat``: ``(9*Cf, 3*s*s)``; ``bias``: ``(3*s*s,)`` f32.
    """
    if buf.device.type == "cpu":
        return sr_tail_chain_plain(buf, skip, wmat, bias, scale, layout)
    if buf.device.type != "cuda":
        raise ValueError(f"sr_tail_chain: unsupported device {buf.device}")
    _check(buf, skip, wmat, bias, scale, layout)
    for name, t, dt in (("buf", buf, torch.bfloat16),
                        ("skip", skip, torch.bfloat16),
                        ("wmat", wmat, torch.bfloat16),
                        ("bias", bias, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"sr_tail_chain: {name} must be {dt}, got {t.dtype}")
        if t.device != buf.device or not t.is_contiguous():
            raise ValueError(f"sr_tail_chain: {name} must be contiguous on {buf.device}")
    from upscale_video_tpu_torch.kernels import build

    n, hp, wp, cf = buf.shape
    h, w, s = hp - 2, wp - 2, scale
    if layout == "planar":
        out = torch.empty((n, h, w, 3 * s * s), dtype=torch.uint8, device=buf.device)
    else:
        out = torch.empty((n, h * s, w * s, 3),
                          dtype=torch.float32 if layout == "model" else torch.uint8,
                          device=buf.device)
    lib = build.library()
    code = lib.uvt_sr_tail(
        buf.data_ptr(), skip.data_ptr(), wmat.data_ptr(), bias.data_ptr(),
        out.data_ptr(), n, h, w, cf, s, LAYOUTS.index(layout),
        torch.cuda.current_stream(buf.device).cuda_stream,
    )
    build.check(code, "sr_tail launch")
    sr_tail_chain.launches += 1
    return out


sr_tail_chain.launches = 0
