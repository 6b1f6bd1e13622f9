"""K2 and K3: the fused SRVGG tail — CUDA kernel wrappers + plain versions.

K2 ports ``upscale_video_tpu/ops/tail_pallas.py:155-319``
(``_tail_chain_kernel`` / ``sr_tail_fused_chain``): from the conv chain's
bordered buffer ``(N, H+2, W+2, Cf)``, Cf up to 128, it computes the tail
conv Cf -> 3*s*s + bias in f32, adds the nearest-s skip of the model-domain
input, and writes one of :data:`LAYOUTS`.  K3 ports
``tail_pallas.py:31-152, 322-331`` (``_tail_kernel`` / ``sr_tail_fused`` /
``sr_tail_fused_batch``): the same tail from a plain activation ``(N, H, W,
Cf)``, Cf up to 512, whose frame border the kernel makes.  The JAX K3
returns the f32 model layout only; here it writes K2's layouts with K2's
epilogue, so a graph on K3 keeps the shuffle-planar and 4:2:0 contracts.
The layouts:

- ``"planar"``: uint8 ``(N, H, W, 3*s*s)`` in (i, j, c) order, c fastest,
  RGB — the shuffle-planar contract (``executor._planar_tail_u8``'s output,
  :func:`~upscale_video_tpu_torch.ops.pixel.planar_to_frames`' input);
- ``"frames"``: uint8 ``(N, s*H, s*W, 3)`` RGB;
- ``"model"``: float32 ``(N, s*H, s*W, 3)`` in the BGR model domain;
- ``"yuv420"`` (even s): uint8 ``(N, H, W, s*s + 2*(s//2)**2)``, the
  packed 4:2:0 contract, exactly
  :func:`~upscale_video_tpu_torch.ops.yuv.yuv420_from_planar` of the
  planar layout with ``full_range``.

The u8 layouts quantize with ``clip(round_half_even(v * 255), 0, 255)``
and fold in the BGR -> RGB flip.  :func:`sr_tail_chain` and
:func:`sr_tail_fused` dispatch on the input's device: CPU -> their plain
versions; CUDA -> a kernel or an exception, picked by shape alone
(:func:`chain_sm90_takes`, :func:`fused_sm90_takes`): the Hopper kernels
of ``csrc/sr_tail_sm90.cu`` (K2 for Cf 64, K3 for Cf a multiple of 32 in
32..192, both at s 2 and 4, every layout in one launch) or the WMMA
kernels of ``csrc/sr_tail.cu`` for every other shape, where ``"yuv420"``
is the planar launch followed by ``yuv420_from_planar`` (counted in
``.yuv_composed``).  ``.launches`` counts kernel launches (one per call),
``.launches_sm90`` those on the Hopper kernel, ``.launches_model`` those
writing the ``"model"`` layout (the tiled and ``--tta`` SR stages).  K2's Hopper kernel reads
its weights as a B image packed once at plan time
(:func:`pack_tail_weights`, the ``wpack`` argument).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from upscale_video_tpu_torch.ops.conv_chain import no_tf32, oihw, pack_ring_weights
from upscale_video_tpu_torch.ops.yuv import yuv420_from_planar

LAYOUTS = ("planar", "frames", "model", "yuv420")
MAX_CHANNELS = 128        # K2: the chain buffer's Cf
MAX_PLAIN_CHANNELS = 512  # K3: a plain activation's Cf
SM90_SCALES = (2, 4)
SM90_MAX_CIN = 192        # K3's Hopper kernel: three 64-channel slices


def chain_sm90_takes(cf: int, scale: int) -> bool:
    """Whether K2 runs on its Hopper kernel: the Compact chain's 64-wide
    buffer at s 2 or 4 (its B image holds one 192-deep K per dy)."""
    return cf == 64 and scale in SM90_SCALES


def fused_sm90_takes(cf: int, scale: int) -> bool:
    """Whether K3 runs on its Hopper kernel: K4's Hopper cin set (a
    multiple of 32 in 32..192, 64-channel slices) at s 2 or 4."""
    return scale in SM90_SCALES and cf % 32 == 0 and 32 <= cf <= SM90_MAX_CIN


def tail_columns(scale: int) -> int:
    """The Hopper kernels' wgmma N for a scale: 3*s*s rounded up to 16."""
    return -(-3 * scale * scale // 16) * 16


def pack_tail_weights(wmat: torch.Tensor, scale: int) -> Optional[torch.Tensor]:
    """K2's Hopper B image of a bf16 ``(9*64, 3*s*s)`` tail weight matrix
    (:func:`~upscale_video_tpu_torch.ops.conv_chain.pack_ring_weights`
    over the 64-wide chain buffer, N = :func:`tail_columns`), else None
    (other shapes and the f32 CPU path need none).  Packed once per model
    (the executor's ``prepare``)."""
    cf = wmat.shape[0] // 9
    if wmat.dtype != torch.bfloat16 or not chain_sm90_takes(cf, scale):
        return None
    return pack_ring_weights(wmat, cf, tail_columns(scale))


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
    if layout == "yuv420" and scale % 2:
        raise ValueError(f"the yuv420 layout needs an even scale, got {scale}")
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
                        layout: str = "planar",
                        full_range: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K2: an f32 VALID conv over the bordered
    buffer (= SAME over the frame, since the ring is zero; TF32 off) +
    bias, + the skip repeated s*s times per channel, then the layout
    (``"yuv420"``: ``yuv420_from_planar`` of the planar layout)."""
    _check(buf, skip, wmat, bias, scale, layout)
    return _tail_plain(buf, skip, wmat, bias, scale, layout, full_range)


def _tail_plain(buf, skip, wmat, bias, scale, layout, full_range):
    with no_tf32():
        y = F.conv2d(buf.to(torch.float32).permute(0, 3, 1, 2), oihw(wmat))
    y = y.permute(0, 2, 3, 1) + bias.to(torch.float32)
    v = y + skip.to(torch.float32).repeat_interleave(scale * scale, dim=-1)
    if layout == "model":
        return _shuffle(v, scale).contiguous()
    if layout == "frames":
        return quantize_u8(_shuffle(v, scale).flip(-1)).contiguous()
    planar = quantize_u8(_planar_order(v, scale)).contiguous()
    if layout == "yuv420":
        return yuv420_from_planar(planar, scale, full_range)
    return planar


def _out_tensor(n, h, w, s, layout, device):
    if layout == "planar":
        return torch.empty((n, h, w, 3 * s * s), dtype=torch.uint8, device=device)
    if layout == "yuv420":
        return torch.empty((n, h, w, s * s + 2 * (s // 2) ** 2),
                           dtype=torch.uint8, device=device)
    return torch.empty((n, h * s, w * s, 3),
                       dtype=torch.float32 if layout == "model" else torch.uint8,
                       device=device)


def _check_cuda(name, tensors, device):
    for arg, t, dt in tensors:
        if t.dtype != dt:
            raise TypeError(f"{name}: {arg} must be {dt}, got {t.dtype}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous on {device}")


def _launch(wrapper, fn, sm90, x, skip, weights, bias, n, h, w, cf, scale,
            layout, full_range):
    """One kernel launch of ``wrapper``'s CUDA path: the Hopper kernel
    (``sm90``) writes every layout itself; the WMMA kernel writes
    ``"yuv420"`` as its planar layout, then ``yuv420_from_planar``."""
    from upscale_video_tpu_torch.kernels import build

    kernel_layout = layout if sm90 or layout != "yuv420" else "planar"
    out = _out_tensor(n, h, w, scale, kernel_layout, x.device)
    args = [x.data_ptr(), skip.data_ptr(), weights.data_ptr(), bias.data_ptr(),
            out.data_ptr(), n, h, w]
    if sm90:
        if fn == "uvt_sr_tail_plain_sm90":
            args.append(cf)
        args += [scale, LAYOUTS.index(layout), int(full_range)]
    else:
        args += [cf, scale, LAYOUTS.index(kernel_layout)]
    build.launch(getattr(build.library(), fn), x.device, f"{fn} launch", *args)
    wrapper.launches += 1
    wrapper.launches_sm90 += sm90
    wrapper.launches_model += layout == "model"
    if kernel_layout != layout:
        wrapper.yuv_composed += 1
        return yuv420_from_planar(out, scale, full_range)
    return out


def sr_tail_chain(buf: torch.Tensor, skip: torch.Tensor, wmat: torch.Tensor,
                  bias: torch.Tensor, scale: int, layout: str = "planar",
                  full_range: bool = False,
                  wpack: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused SRVGG tail over the conv chain's bordered buffer.

    ``buf``: ``(N, H+2, W+2, Cf)`` with a zero ring (``conv3x3_chain(...,
    crop=False)``); ``skip``: ``(N, H, W, 3)`` model-domain input in the
    compute dtype; ``wmat``: ``(9*Cf, 3*s*s)``; ``bias``: ``(3*s*s,)`` f32;
    ``full_range`` the ``"yuv420"`` layout's levels.  On a shape the Hopper
    kernel takes (:func:`chain_sm90_takes`) a CUDA call needs ``wpack``,
    :func:`pack_tail_weights` of ``wmat``, and raises without it.
    """
    if buf.device.type == "cpu":
        return sr_tail_chain_plain(buf, skip, wmat, bias, scale, layout,
                                   full_range)
    if buf.device.type != "cuda":
        raise ValueError(f"sr_tail_chain: unsupported device {buf.device}")
    _check(buf, skip, wmat, bias, scale, layout)
    _check_cuda("sr_tail_chain", (("buf", buf, torch.bfloat16),
                                  ("skip", skip, torch.bfloat16),
                                  ("wmat", wmat, torch.bfloat16),
                                  ("bias", bias, torch.float32)), buf.device)
    n, hp, wp, cf = buf.shape
    sm90 = chain_sm90_takes(cf, scale)
    weights = wmat
    if sm90:
        weights = wpack
        if (weights is None or weights.dtype != torch.bfloat16
                or weights.device != buf.device or not weights.is_contiguous()
                or weights.numel() != 9 * tail_columns(scale) * 64):
            raise ValueError(
                f"sr_tail_chain: the Hopper tail ({cf} -> {3 * scale * scale}) "
                "needs its packed weights (pack_tail_weights, contiguous bf16 "
                "on the input's device)")
    return _launch(sr_tail_chain, "uvt_sr_tail_sm90" if sm90 else "uvt_sr_tail",
                   sm90, buf, skip, weights, bias, n, hp - 2, wp - 2, cf, scale,
                   layout, full_range)


sr_tail_chain.launches = 0
sr_tail_chain.launches_sm90 = 0
sr_tail_chain.launches_model = 0
sr_tail_chain.yuv_composed = 0


def sr_tail_fused_plain(u: torch.Tensor, skip: torch.Tensor,
                        wmat: torch.Tensor, bias: torch.Tensor, scale: int,
                        layout: str = "planar",
                        full_range: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K3: ``u`` padded by one zero pixel, then
    K2's plain tail."""
    _check(u, skip, wmat, bias, scale, layout, border=0,
           max_cf=MAX_PLAIN_CHANNELS)
    return _tail_plain(F.pad(u, (0, 0, 1, 1, 1, 1)), skip, wmat, bias, scale,
                       layout, full_range)


def sr_tail_fused(u: torch.Tensor, skip: torch.Tensor, wmat: torch.Tensor,
                  bias: torch.Tensor, scale: int, layout: str = "planar",
                  full_range: bool = False) -> torch.Tensor:
    """Fused SRVGG tail over a plain activation.

    ``u``: ``(N, H, W, Cf)``, Cf up to 512; ``skip``: ``(N, H, W, 3)``
    model-domain input in the compute dtype; ``wmat``: ``(9*Cf, 3*s*s)``;
    ``bias``: ``(3*s*s,)`` f32; ``full_range`` the ``"yuv420"`` layout's
    levels.  One launch for the batch, on the Hopper kernel where
    :func:`fused_sm90_takes` says so.
    """
    if u.device.type == "cpu":
        return sr_tail_fused_plain(u, skip, wmat, bias, scale, layout,
                                   full_range)
    if u.device.type != "cuda":
        raise ValueError(f"sr_tail_fused: unsupported device {u.device}")
    _check(u, skip, wmat, bias, scale, layout, border=0,
           max_cf=MAX_PLAIN_CHANNELS)
    _check_cuda("sr_tail_fused", (("u", u, torch.bfloat16),
                                  ("skip", skip, torch.bfloat16),
                                  ("wmat", wmat, torch.bfloat16),
                                  ("bias", bias, torch.float32)), u.device)
    n, h, w, cf = u.shape
    sm90 = fused_sm90_takes(cf, scale)
    return _launch(sr_tail_fused,
                   "uvt_sr_tail_plain_sm90" if sm90 else "uvt_sr_tail_plain",
                   sm90, u, skip, wmat, bias, n, h, w, cf, scale, layout,
                   full_range)


sr_tail_fused.launches = 0
sr_tail_fused.launches_sm90 = 0
sr_tail_fused.launches_model = 0
sr_tail_fused.yuv_composed = 0
