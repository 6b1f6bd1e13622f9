"""One file per architecture family: its ncnn graph (``layers``) and its
plain forward (``forward``), with the counts its kernels' metrics need."""
