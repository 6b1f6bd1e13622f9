"""K7: the row-wise Winograd F(2,3) SAME-3x3 conv stack — CUDA kernel
wrapper + plain version.

Port of ``upscale_video_tpu/ops/conv_winograd.py``.  Winograd runs along
rows only and the column taps stay direct ("F(2x1, 3x3)"): per output-row
pair ``2i, 2i+1`` the four row combinations of the input rows
``2i-1 .. 2i+2``

    V0 = d0 - d2,  V1 = d1 + d2,  V2 = d2 - d1,  V3 = d1 - d3

each go through a 1x3 conv against the row-transformed weights
``U_a = sum_dy G[a, dy] w[dy]`` (:func:`transform_weights`), and

    y_even = bias + M0 + M1 + M2,  y_odd = bias + M1 - M2 - M3

That is ``4 * 3 * cin * cout / 2`` MACs per output pixel, 1.5x fewer than
the direct ``9 * cin * cout``.  Output pairs align on even frame rows from
row 0; an odd ``H`` computes the last pair's second row and drops it.

Activations live in K1's bordered bf16 NHWC buffers ``(N, H+2, W+2, C)``
with a zero ring (:mod:`upscale_video_tpu_torch.ops.conv_chain`), one
kernel launch per layer over the frame batch.  :func:`winograd_chain`
dispatches on the input's device: a CPU tensor takes
:func:`winograd_chain_plain`; a CUDA tensor launches a kernel per layer or
raises.  The kernel is chosen by the layer's shape alone
(:func:`sm90_takes`): 64->64 layers run the persistent TMA + wgmma kernel
in ``csrc/conv_winograd_sm90.cu``, every other shape the WMMA kernel in
``csrc/conv_winograd.cu``.  ``winograd_chain.launches`` counts every layer
launch, ``winograd_chain.launches_sm90`` those that went to the sm90
kernel.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from upscale_video_tpu_torch.ops.common import ACT_NONE
from upscale_video_tpu_torch.ops.conv_chain import (
    MAX_CHANNELS, apply_act, check_cuda, check_layers, embed, no_tf32,
    per_channel, run_bordered,
)

# F(2,3): G (4x3) row-transforms the weights
_G = np.array(
    [[1.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0.0, 0.0, 1.0]]
)


class WinoLayer(NamedTuple):
    umat: torch.Tensor   # (4, 3*cin, cout) bf16: U_a, rows in (dx, cin) order
    bias: torch.Tensor   # (cout,) f32
    slope: torch.Tensor  # (cout,) f32: PReLU slopes, or the leaky slope
                         # broadcast; zeros when unused
    act: int             # ACT_NONE / ACT_PRELU / ACT_LEAKY / ACT_RELU

    @property
    def cin(self) -> int:
        return self.umat.shape[1] // 3

    @property
    def cout(self) -> int:
        return self.umat.shape[2]


def transform_weights(w) -> torch.Tensor:
    """HWIO (3, 3, cin, cout) -> (4, 3*cin, cout) f32: ``U_a`` per
    coordinate, K ordered dx-major to match the kernel's column taps."""
    w = torch.as_tensor(w, dtype=torch.float32)
    g = torch.as_tensor(_G, dtype=torch.float32, device=w.device)
    u = torch.einsum("ad,dxio->axio", g, w)
    return u.reshape(4, 3 * w.shape[2], w.shape[3])


def make_wino_layer(weight_hwio, bias=None, slope=None, act: int = ACT_NONE,
                    device: "torch.device | str" = "cpu") -> WinoLayer:
    """A :class:`WinoLayer` from numpy/tensor HWIO weights (the JAX
    ``winograd_chain`` layer-dict fields); ``U`` is computed in f32 and
    rounded once to bf16, as ``conv_winograd.py:265`` does."""
    w = torch.as_tensor(weight_hwio, dtype=torch.float32)
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3) or cin > MAX_CHANNELS or cout > MAX_CHANNELS:
        raise ValueError(
            f"winograd_chain needs 3x3 convs with <={MAX_CHANNELS} channels, "
            f"got weight {tuple(w.shape)}")
    umat = transform_weights(w).to(device=device, dtype=torch.bfloat16)
    return WinoLayer(umat.contiguous(), per_channel(bias, cout, device),
                     per_channel(slope, cout, device), int(act))


def wino_layers_from_jax(layer_dicts, device: "torch.device | str" = "cpu"
                         ) -> List[WinoLayer]:
    """The JAX ``winograd_chain`` layer dicts (numpy HWIO ``weight``,
    optional ``bias``/``slope``, ``act``) as :class:`WinoLayer` s."""
    return [make_wino_layer(np.asarray(d["weight"]), d.get("bias"),
                            d.get("slope"), int(d.get("act", ACT_NONE)),
                            device=device)
            for d in layer_dicts]


def _check_layers(layers: Sequence[WinoLayer], cin0: int) -> None:
    for i, l in enumerate(layers):
        if l.umat.ndim != 3 or l.umat.shape[0] != 4 or l.umat.shape[1] % 3:
            raise ValueError(f"layer {i}: umat {tuple(l.umat.shape)} is not "
                             "(4, 3*cin, cout)")
    check_layers(layers, cin0)


def _wino_layer_plain(y: torch.Tensor, layer: WinoLayer) -> torch.Tensor:
    """One layer on bf16 NCHW ``y`` -> bf16 NCHW, the kernel's rounding
    points: ``V_a`` in bf16, each ``M_a`` an f32 1x3 conv, the output
    transform, bias and activation in f32, one bf16 rounding."""
    n, c, h, w = y.shape
    pairs = (h + 1) // 2
    # frame rows -1 .. 2*pairs (one zero row above, one or two below) and
    # one zero column each side
    yp = F.pad(y, (1, 1, 1, 1 + h % 2))
    d = [yp[:, :, r:r + 2 * pairs:2] for r in range(4)]
    v = (d[0] - d[2], d[1] + d[2], d[2] - d[1], d[1] - d[3])
    # U_a (3*cin, cout), rows (dx, cin) -> OIHW (cout, cin, 1, 3)
    u = layer.umat.to(torch.float32).reshape(4, 3, c, layer.cout)
    m = [F.conv2d(v[a].to(torch.float32), u[a].permute(2, 1, 0)[:, :, None, :])
         for a in range(4)]
    b = layer.bias.view(1, -1, 1, 1)
    y_even = apply_act(b + m[0] + m[1] + m[2], layer, 1)
    y_odd = apply_act(b + m[1] - m[2] - m[3], layer, 1)
    out = torch.stack([y_even, y_odd], dim=3).reshape(n, layer.cout,
                                                      2 * pairs, w)
    return out[:, :, :h].to(torch.bfloat16)


def winograd_chain_plain(x: torch.Tensor, layers: Sequence[WinoLayer],
                         crop: bool = True) -> torch.Tensor:
    """The plain PyTorch version of K7: ``x`` ``(N, H, W, cin)`` rounds to
    bf16 once, then each layer as :func:`_wino_layer_plain` (TF32 off).
    Returns ``(N, H, W, cout)`` bf16 or, with ``crop=False``, the bordered
    ``(N, H+2, W+2, cout)`` layout of the kernel path."""
    _check_layers(layers, x.shape[-1])
    y = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    with no_tf32():
        for l in layers:
            y = _wino_layer_plain(y, l)
    y = y.permute(0, 2, 3, 1).contiguous()
    return y if crop else F.pad(y, (0, 0, 1, 1, 1, 1))


def sm90_takes(cin: int, cout: int) -> bool:
    """Whether a Winograd layer runs on the sm90 kernel: exactly 64 -> 64,
    the width its resident U (98,304 B) and halo ring are sized for
    (``csrc/conv_winograd_sm90.cu``)."""
    return cin == 64 and cout == 64


def launch_wino_layer(src: torch.Tensor, dst: torch.Tensor,
                      layer: WinoLayer) -> None:
    """One K7 launch: bordered ``src`` -> interior of bordered ``dst``
    (whose ring must be zero) on the current stream, on the sm90 kernel
    where :func:`sm90_takes` the layer's shape, else on the WMMA kernel; a
    failed launch raises."""
    from upscale_video_tpu_torch.kernels import build

    n, hp, wp, cin = src.shape
    if (dst.shape != (n, hp, wp, layer.cout) or cin != layer.cin
            or not src.is_contiguous() or not dst.is_contiguous()
            or src.dtype != torch.bfloat16 or dst.dtype != torch.bfloat16):
        raise ValueError(
            f"bordered buffers {tuple(src.shape)}/{src.dtype} -> "
            f"{tuple(dst.shape)}/{dst.dtype} do not fit layer "
            f"{layer.cin}->{layer.cout} (contiguous bf16 required)")
    sm90 = sm90_takes(layer.cin, layer.cout)
    lib = build.library()
    fn = lib.uvt_conv_winograd_layer_sm90 if sm90 else lib.uvt_conv_winograd_layer
    build.launch(
        fn, src.device, "conv_winograd sm90 layer launch" if sm90
        else "conv_winograd layer launch",
        src.data_ptr(), dst.data_ptr(), layer.umat.data_ptr(),
        layer.bias.data_ptr(), layer.slope.data_ptr(),
        n, hp - 2, wp - 2, layer.cin, layer.cout, layer.act,
    )
    winograd_chain.launches += 1
    winograd_chain.launches_sm90 += sm90


def winograd_chain(x: torch.Tensor, layers: Sequence[WinoLayer],
                   crop: bool = True) -> torch.Tensor:
    """Run a stack of SAME 3x3 convs (+bias, +activation) over ``x``
    ``(N, H, W, cin)`` with row-wise Winograd.  Returns
    ``(N, H, W, cout_last)`` bf16, or with ``crop=False`` the bordered
    ``(N, H+2, W+2, cout)`` buffer (zero ring)."""
    if x.device.type == "cpu":
        return winograd_chain_plain(x, layers, crop)
    if x.device.type != "cuda":
        raise ValueError(f"winograd_chain: unsupported device {x.device}")
    _check_layers(layers, x.shape[-1])
    check_cuda(x, layers, [l.umat for l in layers])
    h, w = x.shape[1:3]
    out = run_bordered(embed(x), layers, launch_wino_layer)
    return out[:, 1:h + 1, 1:w + 1, :].contiguous() if crop else out


winograd_chain.launches = 0
winograd_chain.launches_sm90 = 0
