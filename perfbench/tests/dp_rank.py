"""One data-parallel rank at the small sizes, for the CPU tests: the
program patched as small.patch_program does; with FAULT=no_all_reduce in
the environment the gradients' exchange between ranks left out, and with
LATE_WINDOW=1 every rank but rank 0 measuring a window far longer than
rank 0's (its window still has to close when rank 0's does)."""
import json
import os
import sys

import pytest
import torch

from perfbench.drivers import train_dp
from perfbench.tests import small

if __name__ == "__main__":
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    small.patch_program(mp)
    if os.environ.get("FAULT") == "no_all_reduce":
        from egom2p_torch.core import distributed
        mp.setattr(distributed, "all_reduce_grads_", lambda params: None)
    job = json.loads(sys.argv[1])
    if os.environ.get("LATE_WINDOW") == "1" and os.environ["RANK"] != "0":
        job["seconds"] *= 100
    train_dp.rank_main(job)
