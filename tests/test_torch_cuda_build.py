"""Index construction on the card against the same stages on the CPU.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_build.py

Each stage starts from the same inputs on both devices (one seeded CPU
generator draws every weight): bank training (outputs within 1e-4, loss
within 1e-4 relative), ``_learn_split_batched`` (costs and base within
1e-4 relative, values within 1e-4 of the span), a DQN update (parameters
within 1e-6, loss within 1e-5 relative) and a tiny ``build_wisk`` (the
CPU build's assignment, or an Eq. 1 total within 1.10 of it where a bank
trained on the other device moves a split). Two builds on the card are
equal bit for bit, and both packing modes agree there.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import build as tbuild  # noqa: E402
from repro_torch.core import cdf as tcdf  # noqa: E402
from repro_torch.core import dqn as tdqn  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402
from repro_torch.core.cost import exact_workload_cost  # noqa: E402
from repro_torch.core.itemsets import expand_queries  # noqa: E402
from repro_torch.data.synth import make_dataset  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _config(seed=0, **over):
    cfg = tbuild.BuildConfig(
        partition=tpart.PartitionConfig(max_clusters=64, n_steps=20, n_restarts=2, min_objects=64,
                                        query_pad=16, max_split_batch=8),
        packing=tpack.PackingConfig(epochs=2, max_label_queries=8, dqn=tdqn.DQNConfig()),
        cdf_train_steps=40, use_itemsets=False, seed=seed)
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def data():
    ds = make_dataset("fs", n=600, seed=21)
    return ds, make_workload(ds, m=16, dist="MIX", seed=22)


@pytest.mark.parametrize("hidden,layers", [(16, 2), (8, 3)])
def test_bank_training_on_card_matches_cpu(cuda, hidden, layers):
    rng = np.random.default_rng(hidden)
    xs = np.sort(rng.random((46, 34)).astype(np.float32), axis=1)
    ys = np.broadcast_to(np.linspace(0, 1, 34, dtype=np.float32), xs.shape).copy()
    init = tcdf.mlp_init(torch.Generator().manual_seed(3), (1,) + (hidden,) * layers + (1,), n_models=46)
    out = {}
    for dev in ("cpu", cuda):
        p, loss = tcdf._train_mlp_bank({k: v.to(dev) for k, v in init.items()},
                                       torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev),
                                       n_steps=40)
        out[str(dev)] = (tcdf.mlp_apply(p, torch.as_tensor(xs, device=dev)[..., None]).cpu(), loss)
    (a, la), (b, lb) = out.values()
    torch.testing.assert_close(b, a, atol=1e-4, rtol=0)
    assert abs(la - lb) <= 1e-4 * abs(la)


def test_learn_split_batched_on_card_matches_cpu(cuda, data):
    ds, wl = data
    bank = tcdf.build_cdf_bank(ds, n_steps=50, device="cpu")
    qe, qs = expand_queries(wl, [], ds.vocab_size, use_itemsets=False)
    root = tpart._root_subspace(ds, wl.m)
    x0, y0, x1, y1 = root.rect
    subs = [root] + [tpart._SubSpace(np.asarray(r, np.float32), root.obj_ids, root.query_ids)
                     for r in ([x0, y0, (x0 + x1) / 2, y1], [x0, (y0 + y1) / 2, x1, y1])]
    padded = [tpart._pad_queries(wl, qe, qs, s, 16) for s in subs]
    spaces = np.stack([s.rect for s in subs])
    arrays = [np.stack([p[i] for p in padded]) for i in range(4)]
    kw = dict(n_steps=120, n_restarts=4, beta=192.0)
    cpu = tpart._learn_split_batched(bank.tables(), bank.nn_params, spaces, *arrays, **kw)
    card = bank.to(cuda)
    got = tpart._learn_split_batched(card.tables(), card.nn_params, spaces, *arrays, **kw)
    np.testing.assert_allclose(got[0], cpu[0], rtol=1e-4)
    np.testing.assert_allclose(got[2], cpu[2], rtol=1e-4)
    assert np.all(np.abs(got[1] - cpu[1]) <= 1e-4 * (spaces[:, 2:] - spaces[:, :2]))


def test_dqn_update_on_card_matches_cpu(cuda):
    cfg = tdqn.DQNConfig(batch_size=8, capacity=64)
    N, m = 12, 5
    D = (m + 1) * N + m
    rng = np.random.default_rng(0)
    ts = tdqn.train_state_init(torch.Generator().manual_seed(1), D, N, cfg)
    buf = tdqn.replay_init(cfg.capacity, D, N)
    for _ in range(40):
        mask2 = torch.as_tensor(rng.random(N) < 0.5)
        tdqn.replay_add(buf, torch.as_tensor(rng.integers(0, 2, D).astype(np.float32)),
                        int(rng.integers(N)), float(rng.normal()),
                        torch.as_tensor(rng.integers(0, 2, D).astype(np.float32)), mask2,
                        bool(rng.random() < 0.1))
    idx = torch.as_tensor(rng.integers(0, buf.size, cfg.batch_size))
    card_ts = copy.deepcopy(ts)
    for part in (card_ts.params, card_ts.target):
        part.to(cuda)
    card_ts.opt_m = {k: v.to(cuda) for k, v in card_ts.opt_m.items()}
    card_ts.opt_v = {k: v.to(cuda) for k, v in card_ts.opt_v.items()}
    card_buf = tdqn.Replay(*(getattr(buf, f).to(cuda) for f in ("s", "a", "r", "s2", "mask2", "done")),
                           ptr=buf.ptr, size=buf.size)
    for _ in range(3):
        loss = tdqn.dqn_update(ts, buf, idx, cfg)
        card_loss = tdqn.dqn_update(card_ts, card_buf, idx.to(cuda), cfg)
        assert abs(float(card_loss) - float(loss)) <= 1e-5 * abs(float(loss))
    for a, b in zip(list(ts.params.parameters()) + list(ts.target.parameters()),
                    list(card_ts.params.parameters()) + list(card_ts.target.parameters())):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), atol=1e-6, rtol=0)


def test_build_on_card_matches_cpu_and_repeats(cuda, data):
    ds, wl = data
    cpu = tbuild.build_wisk(ds, wl, _config(0), device="cpu")
    a, b = (tbuild.build_wisk(ds, wl, _config(0)) for _ in range(2))
    assert a.bank.device.type == "cuda"
    if not np.array_equal(a.partition.clusters.assign, cpu.partition.clusters.assign):
        eq1 = lambda art: exact_workload_cost(ds, art.partition.clusters, wl).total  # noqa: E731
        assert eq1(a) <= 1.10 * eq1(cpu)
    np.testing.assert_array_equal(a.partition.clusters.assign, b.partition.clusters.assign)
    for pa, pb in zip(a.hierarchy.parents, b.hierarchy.parents):
        np.testing.assert_array_equal(pa, pb)
    for k in a.bank.nn_params:
        assert torch.equal(a.bank.nn_params[k], b.bank.nn_params[k])
    warm = tbuild.warm_start_rebuild(ds, make_workload(ds, m=16, dist="GAU", seed=4), a, _config(0))
    assert warm.bank.device.type == "cuda" and warm.partition.clusters.k >= a.partition.clusters.k


def test_packing_modes_agree_on_card(cuda):
    labels = np.random.default_rng(7).integers(0, 2, (10, 8)).astype(bool)
    cfg = tpack.PackingConfig(epochs=6, dqn=tdqn.DQNConfig(batch_size=16, capacity=128))
    seq = tpack.pack_one_level(labels, cfg, seed=1, mode="sequential", device=cuda)
    bat = tpack.pack_one_level(labels, cfg, seed=1, mode="batched", device=cuda)
    np.testing.assert_array_equal(seq.assign, bat.assign)
    assert (seq.reward_curve, seq.losses) == (bat.reward_curve, bat.losses)
