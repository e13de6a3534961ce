"""The benchmark of ``pvw_tpu_torch``, the PyTorch and CUDA port, on NVIDIA
cards. Data-driven: BENCHMARK.json names each cell's configuration
(``configs/``, with the program's settings it states) and traffic
(``traffic/``, a data file naming its kind, whose code is
``kinds/<kind>.py``), and each per-layer metric's reader (``metrics/``);
``reference/`` holds the plain reference that decides ``correct``, with
each noise stream's draws in ``reference/streams/``, and ``roofline.py``
the peaks and work counts."""
