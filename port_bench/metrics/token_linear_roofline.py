"""token_linear_roofline: the bound of the token linears' work in the
window (each Swin block's qkv, proj, fc1 and fc2) over the device time of
their GEMM kernels, in %.  The port runs them as bf16 ``F.linear`` on
cuBLAS, whose kernels on an H100 with CUDA 12.8 are cuBLASLt's Hopper
GEMMs with the bias epilogue, ``nvjet_tst_128x256_64x4_2x1_v_bz_coopA_
bias_NNN``, ``nvjet_tst_192x192_64x3_1x2_h_bz_coopB_bias_NNN`` and
``nvjet_tst_160x192_64x3_1x2_h_bz_coopB_bias_NNN``; a bf16 GEMM of
another library version (``sm90_xmma_gemm_bf16*``) counts too.  The
convolutions' kernels (the port's ``uvt`` namespaces, cuDNN's
``*fprop*``, the f32 1x1 conv's ``sm80_xmma_fprop_implicit_gemm_f32*``)
never match.  The bound of a frame is, summed
over the family's ``token_linear_work`` (every linear of every block),
the larger of its FLOPs at 989 TFLOP/s and its bytes at 3.35 TB/s, its
bf16 input, output and weights each once."""

import re

from port_bench.flops import launch_bound_s

LAYER = "kernels"
MOVES = "fps"
KERNELS = re.compile(r"nvjet|xmma_gemm_bf16|gemm.*bf16|bf16.*gemm")
NOT_CONV = re.compile(r"uvt|fprop|conv|dgrad|wgrad")


def read(run):
    if run.trace is None or not hasattr(run.family, "token_linear_work"):
        return None
    seconds = run.trace.kernel_seconds(
        lambda n: KERNELS.search(n) is not None and NOT_CONV.search(n) is None)
    if seconds <= 0:
        return None
    t = run.traffic
    per_frame = sum(launch_bound_s(f, b) for f, b in
                    run.family.token_linear_work(run.cfg, t["height"], t["width"]))
    return 100.0 * per_frame * run.n_frames / seconds
