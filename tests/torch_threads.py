"""One torch intra-op thread for a test module.

Under pytest-xdist, several test processes share the machine's cores, and
each torch keeps a pool of as many threads as there are cores. The port's
small CPU ops then wait at every parallel region for threads the other
processes hold: with 6 processes on 8 cores the torch side of the CSS sync
sweep took 20-24 s for each CFO's 128 bursts, and 0.7 s with one thread a
process. A module imports
`one_torch_thread` to run its tests so; the setting is restored after.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
