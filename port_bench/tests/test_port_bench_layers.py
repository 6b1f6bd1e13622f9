"""The harness beyond convolution stacks: weights of ncnn's other weighted
layer types, a family's own count of its work, and the port's kernels found
by namespace; and the pins that hold the existing cells to what they ran
before any of it."""

from __future__ import annotations

import hashlib
import json
import re
import struct
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench import check, ncnn, spec
from port_bench.flops import graph_conv_flops
from port_bench.metrics import glue_share
from port_bench.tests import mixed_family as mixed
from port_bench.tests.tiny import threads
from port_bench.trace import WINDOW, Trace


def _cfg(name):
    return json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())


# What the harness wrote for the benchmark's configurations before it knew
# any layer type beyond Convolution and PReLU, on the CPU: the .bin's length
# and sha256 at seed 11, and graph_conv_flops at 1080p.  Equal bytes mean
# equal weights on every cell, on the CPU and on the GPU alike (one
# generator call per kind, in the same order).
PINNED = {
    "compact2x": ("srvgg", 1205752,
                  "ebe40496fd497c273a237d3252a81d239ab3aa9257f36199a0051773a88c1008",
                  2481949900800.0),
    "valar4x": ("rrdb", 33707420,
                "8befa4433c317f7029f69e66bfaedc0709d40ea2593f9fd81fea9750b632bcb9",
                74932273152000.0),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_existing_configurations_keep_their_bytes_and_work(name):
    family, size, digest, work = PINNED[name]
    fam = spec.load_module(spec.BENCH_DIR / "models" / f"{family}.py", "family")
    cfg = _cfg(name)
    layers = fam.layers(cfg)
    with threads():
        data = ncnn.bin_bytes(layers, ncnn.seeded_weights(layers, 11, "cpu",
                                                          cfg["init"]))
    assert len(data) == size
    assert hashlib.sha256(data).hexdigest() == digest
    assert graph_conv_flops(layers, 1080, 1920) == work
    assert not hasattr(fam, "flops")


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.load_benchmark()["workloads"]])
def test_each_cell_keeps_its_work_and_checked_sample(workload):
    from port_bench.harness import Run

    cell = spec.cell(spec.load_benchmark(), workload)
    work = PINNED[cell.config["name"]][3]
    run = Run(cell, 2 ** 33 + 1, 1.0, False, "cpu")
    try:
        with threads():
            run.write_model()
    finally:
        run.close()
    assert run.flops_per_frame == work * (8 if cell.traffic.get("tta") else 1)
    assert check.n_check(run.flops_per_frame) == 2


# -- a graph of the other weighted types ------------------------------------

def _attrs(line: str) -> dict:
    parts = line.split()
    n_in, n_out = int(parts[2]), int(parts[3])
    return dict(p.split("=", 1) for p in parts[4 + n_in + n_out:])


def test_param_text_writes_each_layer_types_attributes():
    text = ncnn.param_text(mixed.layers(mixed.CONFIG)).splitlines()
    assert text[0] == str(ncnn.NCNN_MAGIC)
    assert text[1] == "13 14"  # layers, blobs (the Split makes two)
    lines = {ln.split()[1]: ln for ln in text[2:]}
    assert lines["table"].split()[:5] == ["MemoryData", "table", "0", "1", "t"]
    assert _attrs(lines["table"]) == {"0": "4", "1": "3", "2": "2"}
    assert _attrs(lines["ln"]) == {"0": "2", "1": "1.000000e-05", "2": "1"}
    assert _attrs(lines["fc"]) == {"0": "3", "1": "1", "2": "6"}
    assert _attrs(lines["squeeze"]) == {"0": "2", "1": "1", "6": "6"}
    assert _attrs(lines["gap"]) == {"0": "1", "4": "1"}
    assert _attrs(lines["dw"]) == {"0": "8", "1": "3", "4": "1", "5": "1",
                                   "6": "72", "7": "8"}
    assert _attrs(lines["up"]) == {"0": "3", "1": "2", "3": "2", "5": "1",
                                   "6": "96"}
    assert lines["split"].split()[2:7] == ["1", "2", "c2", "c2a", "c2b"]


def test_weight_shapes_of_each_type():
    shapes = ncnn.weight_shapes(mixed.layers(mixed.CONFIG))
    assert shapes == {
        "conv_in": {"weight": (8, 3, 3, 3), "bias": (8,)},
        "dw": {"weight": (8, 1, 3, 3), "bias": (8,)},
        "up": {"weight": (3, 8, 2, 2), "bias": (3,)},  # ncnn's (out, in)
        "squeeze": {"weight": (2, 3, 1, 1)},
        "ln": {"gamma": (2,), "beta": (2,)},
        "fc": {"weight": (3, 2), "bias": (3,)},
        "table": {"data": (2, 3, 4)},
        "conv_out": {"weight": (3, 3, 3, 3), "bias": (3,)},
    }
    no_affine = [ncnn.Layer("LayerNorm", "ln", ["a"], ["b"], {0: 4, 2: 0}),
                 ncnn.Layer("MemoryData", "v", [], ["c"], {0: 5})]
    assert ncnn.weight_shapes(no_affine) == {"v": {"data": (5,)}}


def _expected(layers, seed, init):
    """The weights as ``seeded_weights`` documents them, from one normal
    draw over every weight in file order."""
    shapes = ncnn.weight_shapes(layers)
    kinds = {layer.name: layer.type for layer in layers}
    total = sum(int(np.prod(s)) for d in shapes.values() for s in d.values())
    gen = torch.Generator().manual_seed(seed)
    flat, pos, out = torch.randn(total, generator=gen), 0, {}
    for name, d in shapes.items():
        out[name] = {}
        for key, shape in d.items():
            v = flat[pos:pos + int(np.prod(shape))].reshape(shape)
            pos += v.numel()
            if kinds[name] == "LayerNorm":
                v = v * init.get("norm_std", 0.1) + (key == "gamma")
            elif kinds[name] == "MemoryData":
                v = v * init.get("data_std", 0.02)
            else:
                fan_in = int(np.prod(d["weight"][1:]))
                how = ncnn.conv_init(init, name, fan_in)
                if key == "weight":
                    if how["zero_mean"]:
                        v = v - v.mean(dim=tuple(range(1, v.dim())),
                                       keepdim=True)
                    v = (v * how["weight"]).half().float()
                elif how["fill"] is not None:
                    v = torch.full_like(v, how["fill"])
                else:
                    v = v * how["bias"]
            out[name][key] = v
    return out


@pytest.mark.parametrize("init", [
    mixed.CONFIG["init"],
    {"conv_std": 0.05},  # norm_std and data_std at their defaults
])
def test_seeded_weights_follow_the_init_keys(init):
    layers = mixed.layers(mixed.CONFIG)
    got = ncnn.seeded_weights(layers, 2 ** 40 + 3, "cpu", init)
    want = _expected(layers, 2 ** 40 + 3, init)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        for key in want[name]:
            assert torch.equal(got[name][key], want[name][key]), (name, key)
    if "rules" in init:
        fc = got["fc"]["weight"]
        assert float(fc.mean(dim=1).abs().max()) < 1e-3  # zero_mean, f16
        assert torch.equal(got["fc"]["bias"], torch.full((3,), 0.25))
        assert not torch.equal(got["ln"]["gamma"], torch.ones(2))
        assert not torch.equal(got["ln"]["beta"], torch.zeros(2))


def test_prelu_slope_is_needed_only_with_a_prelu():
    layers = mixed.layers(mixed.CONFIG)
    assert "prelu_slope" not in mixed.CONFIG["init"]
    ncnn.seeded_weights(layers, 1, "cpu", mixed.CONFIG["init"])
    with_prelu = layers + [ncnn.Layer("PReLU", "act", ["output"], ["o2"],
                                      {0: 3})]
    with pytest.raises(KeyError, match="prelu_slope"):
        ncnn.seeded_weights(with_prelu, 1, "cpu", mixed.CONFIG["init"])
    init = dict(mixed.CONFIG["init"], prelu_slope=[0.1, 0.3])
    w = ncnn.seeded_weights(with_prelu, 1, "cpu", init)
    base = ncnn.seeded_weights(layers, 1, "cpu", init)
    # the slopes are the second draw: every other weight is as without them
    assert all(torch.equal(w[n][k], base[n][k]) for n in base for k in base[n])
    assert 0.1 <= float(w["act"]["slope"].min()) <= \
        float(w["act"]["slope"].max()) <= 0.3


def _read_back(layers, data: bytes) -> dict:
    """The ``.bin`` read as ncnn's ``load_model`` reads it, layer by layer:
    ``mb.load(n, 0)`` a 4-byte tag then (float16) ``n`` values padded to 4
    bytes; ``mb.load(n, 1)`` ``n`` raw float32."""
    pos, out = 0, {}

    def raw(n):
        nonlocal pos
        v = np.frombuffer(data, "<f4", n, pos).astype(np.float32)
        pos += 4 * n
        return v

    def tagged(n):
        nonlocal pos
        assert struct.unpack_from("<I", data, pos)[0] == ncnn.TAG_F16
        v = np.frombuffer(data, "<f2", n, pos + 4).astype(np.float32)
        pos += 4 + (2 * n + 3) // 4 * 4
        return v

    for layer in layers:
        a, d = layer.attrs, {}
        if layer.type in ("Convolution", "ConvolutionDepthWise",
                          "Deconvolution"):
            d["weight"] = tagged(a[6])
            if a.get(5):
                d["bias"] = raw(a[0])
        elif layer.type == "InnerProduct":
            d["weight"] = tagged(a[2])
            if a.get(1):
                d["bias"] = raw(a[0])
        elif layer.type == "LayerNorm" and a.get(2, 1):
            d["gamma"], d["beta"] = raw(a[0]), raw(a[0])
        elif layer.type == "MemoryData":
            d["data"] = raw(int(np.prod([a[k] for k in (0, 1, 2) if a.get(k)])))
        elif layer.type == "PReLU":
            d["slope"] = raw(a.get(0, 1))
        if d:
            out[layer.name] = d
    assert pos == len(data)
    return out


def test_bin_bytes_lay_each_type_out_as_ncnn_reads_it():
    layers = mixed.layers(mixed.CONFIG)
    w = ncnn.seeded_weights(layers, 7, "cpu", mixed.CONFIG["init"])
    data = ncnn.bin_bytes(layers, w)
    back = _read_back(layers, data)
    assert back.keys() == w.keys()
    for name, d in w.items():
        assert back[name].keys() == d.keys()
        for key, v in d.items():
            np.testing.assert_array_equal(back[name][key],
                                          v.numpy().reshape(-1))
    # conv_out's 81 float16 weights are padded by 2 bytes to 4
    assert len(data) % 4 == 0
    # ncnn's deconvolution reads output channel p's weights at
    # weight_data + kh * kw * inch * p: output channel first
    up = back["up"]["weight"].reshape(3, 8, 2, 2)
    np.testing.assert_array_equal(up[1], w["up"]["weight"][1].numpy())


# -- the work of a frame ----------------------------------------------------

def _gate_free(layers):
    """The graph with its Pooling a Split: the gate then runs at the full
    resolution."""
    return [ncnn.Layer("Split", x.name, x.inputs, x.outputs)
            if x.type == "Pooling" else x for x in layers]


def test_graph_conv_flops_carries_global_pooling_as_one_pixel():
    layers = mixed.layers(mixed.CONFIG)
    h, w = 6, 10
    assert graph_conv_flops(layers, h, w) == mixed.flops(mixed.CONFIG, h, w)
    # unpropagated, the gate's 1x1 squeeze would count at 2h x 2w
    assert graph_conv_flops(_gate_free(layers), h, w) == \
        mixed.flops(mixed.CONFIG, h, w) + 2.0 * 3 * 2 * (4 * h * w - 1)
    windowed = [ncnn.Layer("Input", "input", [], ["in"]),
                ncnn.Layer("Pooling", "pool", ["in"], ["out"],
                           {0: 0, 1: 2, 2: 2})]
    with pytest.raises(ValueError, match="windowed Pooling"):
        graph_conv_flops(windowed, h, w)


@pytest.mark.parametrize("attrs,out_hw", [
    ({1: 3, 3: 2, 4: 1, 18: 1}, (12, 20)),   # k3 s2 pad 1, output pad 1
    ({1: 4, 3: 2, 4: 1}, (12, 20)),           # k4 s2 pad 1
    ({1: 2, 3: 2, 20: 19, 21: 11}, (11, 19)),  # output size given
    ({1: 3, 3: 1}, (8, 12)),                  # k3 s1, uncut
])
def test_deconvolution_output_size_feeds_the_next_count(attrs, out_hw):
    layers = [
        ncnn.Layer("Input", "input", [], ["in"]),
        ncnn.Layer("Deconvolution", "up", ["in"], ["u"],
                   {**attrs, 0: 4, 6: 4 * 3 * attrs[1] ** 2}),
        ncnn.Layer("Convolution", "c", ["u"], ["out"],
                   {0: 1, 1: 1, 6: 4}),
    ]
    k = attrs[1]
    oh, ow = out_hw
    assert graph_conv_flops(layers, 6, 10) == \
        2.0 * k * k * 3 * 4 * 6 * 10 + 2.0 * 4 * oh * ow


def _mixed_cell(family, tta=False):
    return spec.Cell(
        name="mixed-6x10", chips=1, config=mixed.CONFIG,
        traffic={"gpus": 1, "height": 6, "width": 10, "tta": tta},
        limits={}, family=family, end_to_end=[], per_layer=[], readers={})


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("family,expect", [
    (mixed, mixed.flops(mixed.CONFIG, 6, 10)),
    (SimpleNamespace(layers=mixed.layers, flops=lambda cfg, h, w: 7.0e9),
     7.0e9),
    (SimpleNamespace(layers=mixed.layers),
     graph_conv_flops(mixed.layers(mixed.CONFIG), 6, 10)),
], ids=["own_count", "own_count_differs", "graph_count"])
def test_run_takes_the_familys_flops_else_the_graphs(family, expect, tta):
    from port_bench.harness import Run

    run = Run(_mixed_cell(family, tta), 5, 1.0, False, "cpu")
    try:
        model_dir = Path(run.write_model())
        assert run.flops_per_frame == expect * (8 if tta else 1)
        data = (model_dir / "2x_mixed.bin").read_bytes()
        assert data == ncnn.bin_bytes(run.layers, run.weights)
        assert (model_dir / "2x_mixed.param").read_text() == \
            ncnn.param_text(run.layers)
    finally:
        run.close()


# -- the port's kernels -----------------------------------------------------

# Every __global__ of upscale_video_tpu_torch/csrc/ as the profiler names it
# (namespace, name, template arguments), each of which the benchmark's
# former list of kernel names selected.
RECORDED_PORT_KERNELS = [
    "uvt::chain_layer_kernel<64>",
    "uvt_narrow::chain_layer_narrow_kernel<8, 64, 4, 1>",
    "uvt_sm90::chain_layer_sm90_kernel<1>",
    "uvt::conv3x3_fused_kernel<64>",
    "uvt_k4_sm90::conv3x3_fused_sm90_kernel<32, 2>",
    "uvt_q8::q8_layer_kernel<64>",
    "uvt_q8_sm90::q8_layer_sm90_kernel<1, true>",
    "uvt::wino_layer_kernel<64>",
    "uvt_wino_sm90::wino_layer_sm90_kernel<1>",
    "uvt::nlm::nl_means_sm90",
    "uvt_rdb_sm90::rdb_block_sm90_kernel<5>",
    "uvt::sr_tail_kernel<64>",
    "uvt::sr_tail_plain_kernel<64>",
    "uvt_tail_sm90::sr_tail_sm90_kernel<2, 16, 4, 2>",
    "uvt_tail_sm90::sr_tail_plain_sm90_kernel<4, 48, 2, 2, 1>",
]
# the former rule: the port's kernels by name
FORMER_RULE = re.compile(
    r"\b(?:chain_layer_(?:sm90_|narrow_)?kernel|conv3x3_fused(?:_sm90)?_kernel"
    r"|q8_layer(?:_sm90)?_kernel|wino_layer(?:_sm90)?_kernel|nl_means_sm90"
    r"|rdb_block_sm90_kernel|sr_tail(?:_plain)?(?:_sm90)?_kernel)\b")
NOT_THE_PORTS = [
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "AUnaryFunctor<float, float, float, at::native::binary_internal::"
    "MulFunctor<float> >, std::array<char*, 2ul> >(int, at::native::"
    "AUnaryFunctor<float, float, float, at::native::binary_internal::"
    "MulFunctor<float> >, std::array<char*, 2ul>)",
    "void at::native::index_elementwise_kernel<128, 4, at::native::"
    "gpu_index_kernel<at::native::flip_kernel_impl<c10::BFloat16>(at::"
    "TensorIterator&)::{lambda(int)#1}>(int)",
    "void at::native::unrolled_elementwise_kernel<at::native::"
    "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>(int)",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, "
    "unsigned int, 4, 64, 64>(float*, unsigned int)",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_"
    "64x64_64x4_tn_align8>(cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_"
    "64x64_64x4_tn_align8::Params)",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::MeanOps<float, float, float, float>, unsigned int, float, "
    "4> >(at::native::ReduceOp<float, at::native::MeanOps<float, float, "
    "float, float>, unsigned int, float, 4>)",
]

NS_OPEN = re.compile(r"^\s*namespace\s+(\w+)\s*\{")
NS_CLOSE = re.compile(r"^\s*\}\s*//\s*namespace\s+(\w+)")
TEMPLATE = re.compile(r"template\s*<([^>]*)>\s*$")


def _kernel_name(decl: str) -> str:
    """The name in ``__global__ void [__launch_bounds__(...)] name(``."""
    rest = decl.split("__global__", 1)[1].lstrip()[len("void"):].lstrip()
    if rest.startswith("__launch_bounds__"):
        depth, i = 0, len("__launch_bounds__")
        while True:
            depth += {"(": 1, ")": -1}.get(rest[i], 0)
            i += 1
            if depth == 0:
                break
        rest = rest[i:].lstrip()
    return re.match(r"\w+", rest).group(0)


def csrc_kernels() -> list:
    """Each ``__global__`` of the port's ``csrc/`` as the profiler names it:
    ``void <namespaces>::<name><<template arguments>>(<parameters>)``, with
    1 for each int and true for each bool template parameter."""
    out = []
    for path in sorted((spec.ROOT / "upscale_video_tpu_torch" / "csrc")
                       .glob("*.cu")):
        ns, lines = [], path.read_text().splitlines()
        for i, line in enumerate(lines):
            if NS_OPEN.match(line):
                ns.append(NS_OPEN.match(line).group(1))
            elif NS_CLOSE.match(line):
                ns.pop()
            elif line.lstrip().startswith("__global__"):
                name = _kernel_name(" ".join(lines[i:i + 3]))
                tm = TEMPLATE.search(lines[i - 1])
                params = ([p.split()[0] for p in tm.group(1).split(",")]
                          if tm else [])
                targs = ", ".join({"bool": "true"}.get(p, "1") for p in params)
                out.append(f"void {'::'.join(ns + [name])}"
                           + (f"<{targs}>" if params else "")
                           + "(float const*, float*, int)")
    return out


def _base(name: str) -> str:
    return re.sub(r"^void |[<(].*", "", name)


def test_every_port_kernel_is_found_by_its_namespace():
    """Over every ``__global__`` of ``csrc/`` (today the recorded fifteen):
    the namespace rule takes each, and the former list each it named."""
    found = csrc_kernels()
    assert found
    recorded = {_base(n) for n in RECORDED_PORT_KERNELS}
    for name in found:
        assert glue_share.PORT_KERNELS.search(name), name
        if _base(name) in recorded:
            assert FORMER_RULE.search(name), name


@pytest.mark.parametrize("name", RECORDED_PORT_KERNELS + NOT_THE_PORTS)
def test_namespace_rule_selects_what_the_former_list_did(name):
    for written in (name, f"void {name}(CUtensorMap_st, __nv_bfloat16*)"):
        assert bool(glue_share.PORT_KERNELS.search(written)) == \
            bool(FORMER_RULE.search(written)) == (name in RECORDED_PORT_KERNELS)


def _trace(kernels):
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW,
               "ts": 0.0, "dur": 100.0, "tid": 1}]
    t = 0.0
    for name, dur in kernels:
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": t,
                       "dur": dur, "args": {"device": 0}})
        t += dur
    return Trace(events)


def test_glue_share_counts_a_new_port_namespace_as_the_ports():
    run = SimpleNamespace(trace=_trace([
        ("void uvt_x::foo_kernel<3>(float*)", 30.0),
        ("void uvt_rdb_sm90::rdb_block_sm90_kernel<5>(CUtensorMap_st)", 40.0),
        (NOT_THE_PORTS[0], 10.0),
        (NOT_THE_PORTS[4], 20.0),
    ]))
    assert glue_share.read(run) == pytest.approx(30.0)
    assert not FORMER_RULE.search("void uvt_x::foo_kernel<3>(float*)")
