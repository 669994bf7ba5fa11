"""Run a command and print each line of its standard output as it comes,
prefixed by the seconds since the command started and a tab, so that a
script that prints a line a phase (`chip_smoke.py`) is timed phase by phase
on the wall clock, whatever it prints itself:

    python3 maxk_tpu_torch/bench/line_times.py -- python3 chip_smoke.py

Imports nothing of the package, so it also times another checkout's
script from that checkout's directory. Its standard error passes through;
it exits with the command's code."""

import subprocess
import sys
import time


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--"]:
        argv = argv[1:]
    if not argv:
        raise SystemExit("line_times: no command given")
    start = time.perf_counter()
    with subprocess.Popen(argv, stdout=subprocess.PIPE, text=True, bufsize=1) as proc:
        for line in proc.stdout:
            print(f"{time.perf_counter() - start:.1f}\t{line}", end="", flush=True)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
