import time

T0 = time.perf_counter()

from portbench.harness import main  # noqa: E402

raise SystemExit(main(t0=T0))
