"""The benchmark's own tests: the harness's modules and the checkout's root
on the path.  They run on the CPU; a test that needs the card is marked
``cuda`` and decides inside the test."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (HERE, BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
