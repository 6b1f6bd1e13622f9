"""attn_roofline: the bound of the window attention's work in the window
over the device time of the fused-attention kernels, in %.  The port runs
each Swin block's attention through ``F.scaled_dot_product_attention``
pinned to PyTorch's memory-efficient backend, whose forward kernel on
an H100 is CUTLASS's ``fmha_cutlassF_bf16_aligned_64x64_rf_sm80``
(PyTorch 2.11, CUDA 12.8); another ``fmha_cutlassF_*`` or
``AttentionKernel`` instance, or the flash backend's ``flash_fwd_*``,
counts too.  The bound of a frame is, summed over
the family's ``attention_work`` (every block), the larger of QK^T's and
AV's FLOPs at 989 TFLOP/s and the bytes at 3.35 TB/s: q, k and v read
once and the output written once in bf16, the gathered bias and, on a
shifted block, the mask once."""

import re

from port_bench.flops import launch_bound_s

LAYER = "kernels"
MOVES = "fps"
KERNELS = re.compile(r"fmha_cutlassF|flash_fwd|AttentionKernel")


def read(run):
    if run.trace is None or not hasattr(run.family, "attention_work"):
        return None
    seconds = run.trace.kernel_seconds(lambda n: KERNELS.search(n) is not None)
    if seconds <= 0:
        return None
    t = run.traffic
    per_frame = sum(launch_bound_s(f, b) for f, b in
                    run.family.attention_work(run.cfg, t["height"], t["width"]))
    return 100.0 * per_frame * run.n_frames / seconds
