"""Parser for the ncnn ``.param`` text graph format.

Host copy of ``upscale_video_tpu/models/param_parser.py`` (same code): the
original package's ``models/__init__`` imports its JAX executor, so the
port keeps its own jax-free copy.  ``tests/test_torch_host.py`` holds the
two equal.  The port's graph planner
(:mod:`upscale_video_tpu_torch.models.executor`) consumes this IR.

Format (observed from the model zoo files themselves):

- line 1: magic number ``7767517``
- line 2: ``<layer_count> <blob_count>``
- one layer per line::

      <Type> <Name> <num_inputs> <num_outputs> <in blobs...> <out blobs...> <k=v ...>

- attribute keys are integers; a key ``k <= -23300`` denotes an *array*
  attribute with true id ``-k - 23300`` and a value of the form
  ``count,v1,v2,...`` (e.g. ``-23310=1,2.000000e-01`` is array attr 10 with
  one float, the leaky-relu slope fused into Convolution layers in
  ``models/4x_Valar_v1.param``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Union

NCNN_MAGIC = 7767517

AttrValue = Union[int, float, List[int], List[float]]


@dataclass
class NcnnLayer:
    """One layer line of a .param file."""

    type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[int, AttrValue] = field(default_factory=dict)

    def attr(self, key: int, default: AttrValue = 0) -> AttrValue:
        return self.attrs.get(key, default)

    def attr_f(self, key: int, default: float = 0.0) -> float:
        return float(self.attrs.get(key, default))

    def attr_i(self, key: int, default: int = 0) -> int:
        return int(self.attrs.get(key, default))


@dataclass
class NcnnGraph:
    """A parsed ncnn graph in topological (file) order."""

    layers: List[NcnnLayer]
    blob_count: int

    @property
    def input_blobs(self) -> List[str]:
        return [out for l in self.layers if l.type == "Input" for out in l.outputs]

    @property
    def output_blobs(self) -> List[str]:
        """Blobs that are produced but never consumed."""
        consumed = {b for l in self.layers for b in l.inputs}
        return [b for l in self.layers for b in l.outputs if b not in consumed]

    def layer_by_name(self, name: str) -> NcnnLayer:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)

    def count_types(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for l in self.layers:
            out[l.type] = out.get(l.type, 0) + 1
        return out


def _parse_scalar(text: str) -> Union[int, float]:
    """ncnn stores ints and floats undifferentiated; floats carry '.' or 'e'."""
    if "." in text or "e" in text or "E" in text or "nan" in text or "inf" in text:
        return float(text)
    return int(text)


def _parse_attr(token: str) -> tuple[int, AttrValue]:
    key_s, _, val_s = token.partition("=")
    key = int(key_s)
    if key <= -23300:
        # array attribute: id = -key - 23300, value = "count,v1,v2,..."
        real_key = -key - 23300
        parts = val_s.split(",")
        count = int(parts[0])
        vals = [_parse_scalar(p) for p in parts[1 : 1 + count]]
        if len(vals) != count:
            raise ValueError(
                f"array attr {real_key}: declared {count} values, got {len(vals)}"
            )
        # promote to float list if any member is float (mixed arrays are floats)
        if any(isinstance(v, float) for v in vals):
            vals = [float(v) for v in vals]
        return real_key, vals
    return key, _parse_scalar(val_s)


def parse_param(text: str) -> NcnnGraph:
    """Parse .param file text into an :class:`NcnnGraph`.

    Raises ``ValueError`` on bad magic, malformed layer lines, or a
    layer/blob count mismatch with the header.
    """
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if len(lines) < 2:
        raise ValueError("param file too short")
    magic = int(lines[0])
    if magic != NCNN_MAGIC:
        raise ValueError(f"bad ncnn magic {magic}, expected {NCNN_MAGIC}")
    header = lines[1].split()
    layer_count, blob_count = int(header[0]), int(header[1])

    layers: List[NcnnLayer] = []
    for ln in lines[2:]:
        tokens = ln.split()
        if len(tokens) < 4:
            raise ValueError(f"malformed layer line: {ln!r}")
        ltype, name = tokens[0], tokens[1]
        n_in, n_out = int(tokens[2]), int(tokens[3])
        pos = 4
        inputs = tokens[pos : pos + n_in]
        pos += n_in
        outputs = tokens[pos : pos + n_out]
        pos += n_out
        if len(inputs) != n_in or len(outputs) != n_out:
            raise ValueError(f"layer {name}: blob list shorter than declared counts")
        attrs: Dict[int, AttrValue] = {}
        for tok in tokens[pos:]:
            k, v = _parse_attr(tok)
            attrs[k] = v
        layers.append(NcnnLayer(ltype, name, inputs, outputs, attrs))

    if len(layers) != layer_count:
        raise ValueError(f"header declares {layer_count} layers, found {len(layers)}")

    seen_blobs = set()
    for l in layers:
        seen_blobs.update(l.outputs)
    if len(seen_blobs) != blob_count:
        raise ValueError(
            f"header declares {blob_count} blobs, found {len(seen_blobs)}"
        )

    return NcnnGraph(layers=layers, blob_count=blob_count)


def parse_param_file(path: str) -> NcnnGraph:
    with open(path, "r", encoding="utf-8") as f:
        return parse_param(f.read())


def emit_param(graph: NcnnGraph) -> str:
    """Serialize an :class:`NcnnGraph` back to .param text.

    Used by tests to synthesize models and by the calibration tool to dump
    derived graphs; round-trips through :func:`parse_param`.
    """
    out = [str(NCNN_MAGIC), f"{len(graph.layers)} {graph.blob_count}"]
    for l in graph.layers:
        parts = [f"{l.type:<16}", f"{l.name:<24}", str(len(l.inputs)), str(len(l.outputs))]
        parts += l.inputs + l.outputs
        for k, v in l.attrs.items():
            if isinstance(v, list):
                vals = ",".join(_fmt_scalar(x) for x in v)
                parts.append(f"{-(k + 23300)}={len(v)},{vals}")
            else:
                parts.append(f"{k}={_fmt_scalar(v)}")
        out.append(" ".join(parts))
    return "\n".join(out) + "\n"


def _fmt_scalar(v: Union[int, float]) -> str:
    if isinstance(v, float):
        return f"{v:e}"
    return str(v)
