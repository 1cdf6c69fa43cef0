"""The decoder-only families served over a ``("data", "model")`` mesh of
gloo ranks on the CPU, laid out as the reference's rules place them
(ZeRO-3 ``wembed``, tensor-parallel ``heads`` / ``mlp`` / ``vocab``, the
decode cache's slots split over ``kv_seq``), against the port on one
device.

One pool of four ranks (tests/test_torch_ranks.py); the layouts ``(data,
model)`` are (2, 2) and (1, 2) (the pool's first two ranks). tinyllama,
phi-3-vision, qwen2-moe and deepseek-v3 at ``reduced()`` (f32, 2 layers),
the parameters drawn from one seed on every rank and on one device:

* the prefill logits of each rank's rows within ``F32_REL`` (1e-4) of the
  largest of one device's prefill of the rank's data shard alone (the MoE
  capacity counts the shard's tokens, as the reference's);
* the vocab-parallel ``embed_lookup`` bit-equal to one device's rows;
* decode steps into a cache of ``N_SLOTS`` slots whose positions cross the
  block boundary of the slots over ``model``, then one at position
  ``N_SLOTS`` (the clamp past the end writes the last slot, on the last
  block's rank), and ``long_ctx`` decode steps of one row whose slots split
  over every rank, each within ``F32_REL`` of one device's decode of the
  whole batch; the cache itself equal to one device's blocks. The caches
  are f32 here: a bf16 cache rounds what each layout computes in f32, and
  a value that differs in its last f32 bits can round to the neighbouring
  bf16 value (tests/test_torch_moe_sharded.py holds the bf16 cache);
* each collective census equal to the abstract mesh's
  (``make_abstract_mesh``) integer for integer;
* each rank's parameter bytes plus its rows' batch bytes equal to the dry
  run's ``argument_bytes`` for the cell, which equal its
  ``rules_argument_bytes``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import collective_census, make_abstract_mesh  # noqa: E402
from repro_torch.sharding.rules import named_sharding  # noqa: E402
from repro_torch.train.step import build_steps  # noqa: E402

from test_torch_ranks import RankPool  # noqa: E402

F32_REL = 1e-4
ARCHS = ("tinyllama-1.1b", "phi-3-vision-4.2b", "qwen2-moe-a2.7b", "deepseek-v3-671b")
LAYOUTS = [(2, 2), (1, 2)]
B, S = 4, 32  # prefill
N_SLOTS, N_DEC = 8, 7  # decode: positions 0..5 (crossing slot 4 at model=2), then 8
N_LONG = 8  # long-context decode slots, over every rank
SEED = 0


def config(arch: str):
    return dataclasses.replace(get_config(arch).reduced(), n_layers=2)


def inputs(arch: str):
    """The prefill batch (torch, the batch spec's shapes and dtypes), the
    decode tokens and the long-context tokens (numpy), seeded."""
    cfg = config(arch)
    rng = np.random.default_rng(7)
    sds, _ = build_steps(cfg, device="meta").batch_spec("prefill", S, B)
    batch = {}
    for k, s in sds.items():
        if s.dtype == torch.int32:
            batch[k] = torch.from_numpy(rng.integers(0, cfg.vocab, s.shape).astype(np.int32))
        else:
            batch[k] = torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32)).to(
                s.dtype)
    dec = rng.integers(0, cfg.vocab, (B, N_DEC)).astype(np.int32)
    long = rng.integers(0, cfg.vocab, (1, 5)).astype(np.int32)
    return cfg, batch, dec, long


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    d = tmp_path_factory.mktemp("rendezvous")
    p = RankPool(4, f"file://{d}/world4")
    yield p
    p.close()


_RUNS = {}


def _run(pool, arch, layout):
    key = (arch, layout)
    if key not in _RUNS:
        cfg, batch, dec, long = inputs(arch)
        _RUNS[key] = pool.run("layout_serve", layout, cfg, SEED, batch, dec, N_SLOTS, long,
                              N_LONG)
    return _RUNS[key]


_ONE = {}


def _one_device(arch):
    """One device's prefill of each data shard (at 1 and 2 data ranks), its
    embedding table, its decode of the whole batch and its long-context
    decode, each with an f32 cache."""
    if arch not in _ONE:
        cfg, batch, dec, long = inputs(arch)
        one = build_steps(cfg, device="cpu")
        model = one.init_state(torch.Generator().manual_seed(SEED))["params"]
        out = dict(table=model.embed.table.detach().numpy())
        for d in (1, 2):
            n = B // d
            out[d] = [one.prefill_step(model, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
                      .numpy() for i in range(d)]
        for name, toks, n_slots in (("decode", dec, N_SLOTS), ("long", long, N_LONG)):
            cache = {k: v.float() for k, v in one.init_cache(toks.shape[0], n_slots).items()}
            got = []
            for t in range(toks.shape[1]):
                pos = N_SLOTS if (name == "decode" and t == toks.shape[1] - 1) else t
                lo, cache = one.decode_step(model, cache, torch.from_numpy(toks[:, t:t + 1]),
                                            torch.tensor(pos, dtype=torch.int32))
                got.append(lo.numpy())
            out[name] = got
            out[f"{name}_cache"] = {k: v.numpy() for k, v in cache.items()}
        _ONE[arch] = out
    return _ONE[arch]


def _close(got, want, what, rel=F32_REL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.isfinite(got)), what
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= rel * scale, f"{what}: max |err| {err} > {rel} x {scale}"


def _abstract_censuses(arch, layout):
    """The censuses of the prefill, a decode step and a long-context decode
    step at the same shapes on an abstract mesh."""
    cfg, batch, dec, long = inputs(arch)
    steps = build_steps(cfg, mesh=make_abstract_mesh(data=layout[0], model=layout[1]))
    model = steps.bundle.init(torch.Generator(), "meta")
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in batch.items()}
    out = {}
    with collective_census() as c:
        steps.prefill_step(model, meta)
    out["prefill"] = (c.bytes, c.counts)
    for name, b, n, long_ctx in (("decode", B, N_SLOTS, False), ("long", 1, N_LONG, True)):
        cache = {k: v.float() for k, v in steps.init_cache(b, n, long_ctx).items()}
        with collective_census() as c:
            steps.decode_step(model, cache, torch.empty((b, 1), dtype=torch.int32, device="meta"),
                              torch.zeros((), dtype=torch.int32, device="meta"), long_ctx)
        out[name] = (c.bytes, c.counts)
    return out


def _ranks(got, layout):
    n = layout[0] * layout[1]
    assert all(g is None for g in got[n:]) and all(g is not None for g in got[:n])
    return got[:n]


CASES = [(a, lay) for a in ARCHS for lay in LAYOUTS]
IDS = [f"{a}-{lay[0]}x{lay[1]}" for a, lay in CASES]


@pytest.mark.parametrize("arch,layout", CASES, ids=IDS)
def test_prefill_over_the_rules_layout_matches_one_device(pool, arch, layout):
    one = _one_device(arch)[layout[0]]
    for r, g in enumerate(_ranks(_run(pool, arch, layout), layout)):
        _close(g["prefill"], one[r // layout[1]], f"{arch} {layout} rank {r} prefill")


@pytest.mark.parametrize("arch,layout", CASES, ids=IDS)
def test_vocab_parallel_embedding_is_bit_equal(pool, arch, layout):
    _, batch, _, _ = inputs(arch)
    table = _one_device(arch)["table"]
    n = B // layout[0]
    for r, g in enumerate(_ranks(_run(pool, arch, layout), layout)):
        i = r // layout[1]
        want = table[batch["tokens"][i * n:(i + 1) * n].numpy()]
        assert g["embed"].dtype == want.dtype and np.array_equal(g["embed"], want), (arch, r)


@pytest.mark.parametrize("arch,layout", CASES, ids=IDS)
def test_decode_across_slot_blocks_at_the_clamp_and_long_context(pool, arch, layout):
    one = _one_device(arch)
    cfg = config(arch)
    for r, g in enumerate(_ranks(_run(pool, arch, layout), layout)):
        i, j = divmod(r, layout[1])
        n = g["rows"]
        for t, lo in enumerate(g["decode"]):
            _close(lo, one["decode"][t][i * n:(i + 1) * n], f"{arch} {layout} rank {r} step {t}")
        for t, lo in enumerate(g["long"]):
            _close(lo, one["long"][t], f"{arch} {layout} rank {r} long step {t}")
        # the caches: this rank's rows and slots of one device's
        steps = build_steps(cfg, mesh=make_abstract_mesh(rank=r, data=layout[0],
                                                         model=layout[1]))
        for name, n_slots, long_ctx in (("decode", N_SLOTS, False), ("long", N_LONG, True)):
            _, specs = steps.cache_spec(B if not long_ctx else 1, n_slots, long_ctx)
            for k, block in g[f"{name}_cache"].items():
                whole = one[f"{name}_cache"][k]
                sh = named_sharding(steps.mesh, specs[k], steps.rules)
                _close(block, whole[sh.index(whole.shape)], f"{arch} rank {r} {name} cache {k}")
        if j == layout[1] - 1:  # the clamp wrote the last slot; nothing wrote the one before
            for k, block in g["decode_cache"].items():
                assert np.abs(block[:, :, -1]).max() > 0 and not block[:, :, -2].any(), (arch, k)


@pytest.mark.parametrize("arch,layout", CASES, ids=IDS)
def test_censuses_equal_the_abstract_mesh(pool, arch, layout):
    want = _abstract_censuses(arch, layout)
    for r, g in enumerate(_ranks(_run(pool, arch, layout), layout)):
        assert g["prefill_census"] == want["prefill"], (arch, r)
        assert all(c == want["decode"] for c in g["decode_census"]), (arch, r)
        assert all(c == want["long"] for c in g["long_census"]), (arch, r)
    ops = {op for by_op in want["prefill"][0].values() for op in by_op}
    assert {"all-gather", "all-reduce"} <= ops  # ZeRO-3 gathers, row-parallel sums


@pytest.mark.parametrize("arch,layout", CASES, ids=IDS)
def test_parameter_bytes_equal_the_dry_run(pool, arch, layout):
    cfg, batch, _, _ = inputs(arch)
    rec = dryrun.run_cell(arch, "prefill_32k", f"data={layout[0]},model={layout[1]}", seq=S,
                          batch=B, cfg=cfg)
    mem = rec["memory"]
    assert mem["argument_bytes"] == mem["rules_argument_bytes"]
    mesh = make_abstract_mesh(data=layout[0], model=layout[1])
    steps = build_steps(cfg, mesh=mesh)
    _, specs = steps.batch_spec("prefill", S, B)
    rows = sum(math.prod(named_sharding(mesh, specs[k], steps.rules).shard_shape(v.shape))
               * v.element_size() for k, v in batch.items())
    for r, g in enumerate(_ranks(_run(pool, arch, layout), layout)):
        assert g["param_bytes"] + rows == mem["argument_bytes"], (arch, r)
