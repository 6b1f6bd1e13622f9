"""One file per architecture family: its ncnn graph (``layers``) and its
plain forward (``forward``), with the counts its kernels' metrics need,
and, where the graph does not show all of its work, its own count of a
frame's (``flops(cfg, height, width)``, by the convention in
``port_bench/flops.py``)."""
