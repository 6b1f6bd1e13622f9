"""K2 and K3: the fused SRVGG tail — CUDA kernel wrappers + plain versions.

K2 ports ``upscale_video_tpu/ops/tail_pallas.py:155-319``
(``_tail_chain_kernel`` / ``sr_tail_fused_chain``): from the conv chain's
bordered buffer ``(N, H+2, W+2, Cf)``, Cf up to 128, it computes the tail
conv Cf -> 3*s*s + bias in f32, adds the nearest-s skip of the model-domain
input, and writes one of :data:`LAYOUTS`.  K3 ports
``tail_pallas.py:31-152, 322-331`` (``_tail_kernel`` / ``sr_tail_fused`` /
``sr_tail_fused_batch``): the same tail from a plain activation ``(N, H, W,
Cf)``, Cf up to 512, whose frame border the kernel predicates.  The JAX K3
returns the f32 model layout only; here it writes K2's three layouts with
K2's epilogue, so a graph on K3 keeps the shuffle-planar and 4:2:0
contracts.  The layouts:

- ``"planar"``: uint8 ``(N, H, W, 3*s*s)`` in (i, j, c) order, c fastest,
  RGB — the shuffle-planar contract (``executor._planar_tail_u8``'s output,
  :func:`~upscale_video_tpu_torch.ops.pixel.planar_to_frames`' input);
- ``"frames"``: uint8 ``(N, s*H, s*W, 3)`` RGB;
- ``"model"``: float32 ``(N, s*H, s*W, 3)`` in the BGR model domain.

The u8 layouts quantize with ``clip(round_half_even(v * 255), 0, 255)``
and fold in the BGR -> RGB flip.  :func:`sr_tail_chain` and
:func:`sr_tail_fused` dispatch on the input's device: CPU -> their plain
versions; CUDA -> the kernels in ``csrc/sr_tail.cu`` or an exception.
``sr_tail_chain.launches`` and ``sr_tail_fused.launches`` count kernel
launches (one per call).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from upscale_video_tpu_torch.ops.conv_chain import no_tf32, oihw

LAYOUTS = ("planar", "frames", "model")
MAX_CHANNELS = 128        # K2: the chain buffer's Cf
MAX_PLAIN_CHANNELS = 512  # K3: a plain activation's Cf


def _check(buf, skip, wmat, bias, scale, layout, border=2,
           max_cf=MAX_CHANNELS):
    """``border`` is 2 for K2's bordered buffer, 0 for K3's plain input."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")
    if buf.ndim != 4 or skip.ndim != 4:
        raise ValueError("buf and skip must be NHWC")
    n, hp, wp, cf = buf.shape
    cout = 3 * scale * scale
    if scale < 1 or cout > MAX_CHANNELS or not 0 < cf <= max_cf:
        raise ValueError(f"scale {scale} / {cf} channels outside the kernel's range")
    if tuple(skip.shape) != (n, hp - border, wp - border, 3):
        raise ValueError(f"skip {tuple(skip.shape)} does not match input "
                         f"{tuple(buf.shape)} (bordered by {border // 2} pixel)")
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
    return _tail_plain(buf, skip, wmat, bias, scale, layout)


def _tail_plain(buf, skip, wmat, bias, scale, layout):
    with no_tf32():
        y = F.conv2d(buf.to(torch.float32).permute(0, 3, 1, 2), oihw(wmat))
    y = y.permute(0, 2, 3, 1) + bias.to(torch.float32)
    v = y + skip.to(torch.float32).repeat_interleave(scale * scale, dim=-1)
    if layout == "model":
        return _shuffle(v, scale).contiguous()
    if layout == "planar":
        return quantize_u8(_planar_order(v, scale)).contiguous()
    return quantize_u8(_shuffle(v, scale).flip(-1)).contiguous()


def _out_tensor(n, h, w, s, layout, device):
    if layout == "planar":
        return torch.empty((n, h, w, 3 * s * s), dtype=torch.uint8, device=device)
    return torch.empty((n, h * s, w * s, 3),
                       dtype=torch.float32 if layout == "model" else torch.uint8,
                       device=device)


def _check_cuda(name, tensors, device):
    for arg, t, dt in tensors:
        if t.dtype != dt:
            raise TypeError(f"{name}: {arg} must be {dt}, got {t.dtype}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous on {device}")


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
    _check_cuda("sr_tail_chain", (("buf", buf, torch.bfloat16),
                                  ("skip", skip, torch.bfloat16),
                                  ("wmat", wmat, torch.bfloat16),
                                  ("bias", bias, torch.float32)), buf.device)
    from upscale_video_tpu_torch.kernels import build

    n, hp, wp, cf = buf.shape
    h, w, s = hp - 2, wp - 2, scale
    out = _out_tensor(n, h, w, s, layout, buf.device)
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


def sr_tail_fused_plain(u: torch.Tensor, skip: torch.Tensor,
                        wmat: torch.Tensor, bias: torch.Tensor, scale: int,
                        layout: str = "planar") -> torch.Tensor:
    """Plain PyTorch version of K3: ``u`` padded by one zero pixel, then
    K2's plain tail."""
    _check(u, skip, wmat, bias, scale, layout, border=0,
           max_cf=MAX_PLAIN_CHANNELS)
    return _tail_plain(F.pad(u, (0, 0, 1, 1, 1, 1)), skip, wmat, bias, scale,
                       layout)


def sr_tail_fused(u: torch.Tensor, skip: torch.Tensor, wmat: torch.Tensor,
                  bias: torch.Tensor, scale: int,
                  layout: str = "planar") -> torch.Tensor:
    """Fused SRVGG tail over a plain activation.

    ``u``: ``(N, H, W, Cf)``, Cf up to 512; ``skip``: ``(N, H, W, 3)``
    model-domain input in the compute dtype; ``wmat``: ``(9*Cf, 3*s*s)``;
    ``bias``: ``(3*s*s,)`` f32.  One launch for the batch.
    """
    if u.device.type == "cpu":
        return sr_tail_fused_plain(u, skip, wmat, bias, scale, layout)
    if u.device.type != "cuda":
        raise ValueError(f"sr_tail_fused: unsupported device {u.device}")
    _check(u, skip, wmat, bias, scale, layout, border=0,
           max_cf=MAX_PLAIN_CHANNELS)
    _check_cuda("sr_tail_fused", (("u", u, torch.bfloat16),
                                  ("skip", skip, torch.bfloat16),
                                  ("wmat", wmat, torch.bfloat16),
                                  ("bias", bias, torch.float32)), u.device)
    from upscale_video_tpu_torch.kernels import build

    n, h, w, cf = u.shape
    out = _out_tensor(n, h, w, scale, layout, u.device)
    lib = build.library()
    code = lib.uvt_sr_tail_plain(
        u.data_ptr(), skip.data_ptr(), wmat.data_ptr(), bias.data_ptr(),
        out.data_ptr(), n, h, w, cf, scale, LAYOUTS.index(layout),
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    build.check(code, "sr_tail_fused launch")
    sr_tail_fused.launches += 1
    return out


sr_tail_fused.launches = 0
