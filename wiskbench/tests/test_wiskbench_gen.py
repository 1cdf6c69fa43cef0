"""The frozen generators give the port's arrays for the same seed."""
import numpy as np
import pytest

from repro_torch.data.synth import make_dataset as port_dataset
from repro_torch.data.workloads import make_workload as port_workload
from wiskbench.gen.pool import make_pool
from wiskbench.gen.synth import make_dataset
from wiskbench.gen.workloads import make_workload


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("profile", ["osm", "fs"])
def test_generators_equal_the_ports(profile, seed):
    ours, theirs = make_dataset(profile, n=20_000, seed=seed), port_dataset(profile, n=20_000, seed=seed)
    for key in ("locs", "kw_ids", "kw_bitmap", "kw_freq"):
        a, b = getattr(ours, key), getattr(theirs, key)
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    for dist in ("MIX", "GAU"):
        q = make_workload(ours, m=2000, dist=dist, seed=seed + 7)
        w = port_workload(theirs, m=2000, dist=dist, seed=seed + 7)
        for key in ("rects", "kw_ids", "kw_bitmap"):
            assert np.array_equal(getattr(q, key), getattr(w, key)), (dist, key)


def test_pool_is_a_function_of_the_seed():
    data = make_dataset("osm", n=5_000, seed=0)
    traffic = dict(batch=32, pool_batches=3, dist="MIX", region_frac=0.0005, n_keywords=5)
    big = 2 ** 31 + 12345
    a, b, c = (make_pool(traffic, data, s) for s in (big, big, big + 1))
    assert all(np.array_equal(x.rects, y.rects) for x, y in zip(a, b))
    assert not np.array_equal(a[0].rects, c[0].rects)
    # the shuffle mixes MIX's UNI and LAP halves into every batch
    assert sum(x.m for x in a) == 96
