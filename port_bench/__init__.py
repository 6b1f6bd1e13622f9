"""The benchmark of ``upscale_video_tpu_torch``, the PyTorch and CUDA port.

``python -m port_bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the GPUs of the
machine it starts on and prints one JSON line.  Everything that belongs to
one configuration, traffic mix or metric is a file of its own, found by the
name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model's published widths and how it is run;
- ``models/<family>.py``: the family's ncnn graph and its plain forward
  (and its own ``flops`` where the graph does not show all its work);
- ``traffic/<traffic>.json``: resolution, contract, GPUs, source pool;
- ``limits/<workload>.json``: the limits of the output comparison, with
  the readings they were set from;
- ``metrics/<metric>.py``: one reader per metric.

The reference (``reference.py``, ``models/``) is plain PyTorch in float32
and imports nothing of the port or of JAX.
"""
