"""Prefix each line read from stdin with the seconds since the first one,
flushed line by line: a phase's wall from a program's own log lines.

    python3 chip_smoke.py | python3 tools/stamp_lines.py > stamped.log
"""

import sys
import time


def main():
    t0 = time.time()
    for line in sys.stdin:
        sys.stdout.write(f"{time.time() - t0:9.2f} {line}")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
