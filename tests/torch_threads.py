"""The port's tests run torch on one thread: import `one_torch_thread` into a
test module (it is autouse, module-scoped).

Why: the tier-1 run has six workers on eight cores, and torch's thread pools
in each of them fight over the cores. The port's tests run many small ops,
which gain nothing from more threads: under six workers with torch's full
pools, the fine-tuning tests ran 40-100 times slower than alone, and the
whole suite ~280 s longer."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
