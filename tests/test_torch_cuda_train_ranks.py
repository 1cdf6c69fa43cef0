"""LM training over a mesh of ranks on the card: the collectives' backward
and a reduced ``train_step`` over two gloo ranks sharing ``cuda:0`` (NCCL
takes one card a rank), against one device.

* ``psum``, ``pvary`` and ``all_gather`` over ``model`` on CUDA tensors:
  the forward values and the reference's transposes (the cotangent
  through, the cotangents summed, a reduce-scatter), and their census;
* qwen2-moe at ``reduced()`` (f32, AdamW, no TF32) on ``(1, 2)``: two
  ``train_step``s, each rank's loss and grad_norm within 1e-5 of one
  device's on the card (one data rank: the capacity is the whole batch's
  either way), each rank's block of every state leaf within 1e-4 of the
  leaf's largest value, every whole leaf bit-identical on both ranks;
* tinyllama, deepseek-v3, xlstm-125m and jamba at ``reduced()`` served on
  ``(1, 2)`` in the rules' layout against one device on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train_ranks.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.train.step import build_steps  # noqa: E402
from repro_torch.tree import leaves, module_tree  # noqa: E402

from test_torch_ranks import RankPool  # noqa: E402

pytestmark = pytest.mark.cuda

REL = 1e-5
LEAF_REL = 1e-4
ARCH = "qwen2-moe-a2.7b"


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    d = tmp_path_factory.mktemp("rendezvous")
    p = RankPool(2, f"file://{d}/world2", device="cuda:0")
    yield p
    p.close()


def _values(tree):
    """A parameter tree (``module_tree``) as the same tree of host arrays."""
    if isinstance(tree, dict):
        return {k: _values(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def test_collectives_backward_on_the_card(pool):
    got = pool.run("collective_grads", (1, 2))
    c = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["y"], np.full((3, 4), 3.0, np.float32))
        np.testing.assert_array_equal(g["gp"], c * (r + 1))  # passes through
        np.testing.assert_array_equal(g["gv"], c * 3)  # summed over model
        np.testing.assert_array_equal(g["g"][0], np.full((3, 4), 1.0, np.float32))
        np.testing.assert_array_equal(g["g"][1], np.full((3, 4), 2.0, np.float32))
        cg = np.arange(24.0, dtype=np.float32).reshape(2, 3, 4)
        np.testing.assert_array_equal(g["ga"], cg[r] * 3)  # reduce-scattered
        nbytes, counts = g["census"]
        assert counts == {"model": {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1}}
        assert nbytes == {"model": {"all-reduce": 96, "all-gather": 96, "reduce-scatter": 48}}


def test_train_step_over_two_ranks_on_the_card_matches_one_device(pool):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH).reduced()
    one = build_steps(cfg, device="cuda:0")
    state = one.init_state(torch.Generator().manual_seed(0))
    values = _values(module_tree(state["params"]))
    rng = np.random.default_rng(11)
    batches = [dict(tokens=rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))
               for _ in range(2)]
    got = pool.run("lm_train", (1, 2), cfg, values, batches)
    metrics = []
    for b in batches:
        state, m = one.train_step(state, {k: torch.from_numpy(v).cuda() for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"]), float(m["lr"])))
    want = [x.detach().cpu().numpy() for x in leaves(state)]
    for r, (ms, _, blocks) in enumerate(got):
        for a, b in zip(ms, metrics):
            assert np.allclose(a, b, rtol=REL, atol=0), (r, a, b)
        for (name, block, index), w in zip(blocks, want):
            err = float(np.max(np.abs(block - w[index]), initial=0.0))
            assert err <= LEAF_REL * float(np.max(np.abs(w), initial=0.0)), (r, name, err)
    for j, (name, block, index) in enumerate(got[0][2]):
        if not any(s.start for s in index) and not any(s.start for s in got[1][2][j][2]):
            np.testing.assert_array_equal(got[1][2][j][1], block, err_msg=name)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v3-671b", "xlstm-125m",
                                  "jamba-v0.1-52b"])
def test_rules_layout_serves_over_two_ranks_on_the_card(pool, arch):
    """``(1, 2)`` in the rules' layout (tensor-parallel heads, mlp, vocab
    and ``inner``, the Mamba state split with it; the cache's slots split
    over model) on the card: the prefill and each decode step (f32 caches,
    positions across the slot blocks, one at the clamp past the end; then
    long-context steps) within 1e-4 of the largest of one device's logits
    on the card, the embedding bit-equal. jamba at one superblock of 4."""
    import dataclasses

    torch.backends.cuda.matmul.allow_tf32 = False
    reduced = get_config(arch).reduced()
    cfg = dataclasses.replace(reduced, n_layers=reduced.attn_every or 2)
    rng = np.random.default_rng(7)
    B, S, n_slots, n_long = 4, 32, 8, 8
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    dec = rng.integers(0, cfg.vocab, (B, 7)).astype(np.int32)
    long = rng.integers(0, cfg.vocab, (1, 5)).astype(np.int32)
    got = pool.run("layout_serve", (1, 2), cfg, 0, dict(tokens=toks), dec, n_slots, long, n_long)
    one = build_steps(cfg, device="cuda:0")
    model = one.init_state(torch.Generator().manual_seed(0))["params"]
    want = one.prefill_step(model, dict(tokens=torch.from_numpy(toks).cuda())).cpu().numpy()
    steps = {}
    for name, t_, n in (("decode", dec, n_slots), ("long", long, n_long)):
        cache = {k: v.float() for k, v in one.init_cache(t_.shape[0], n).items()}
        steps[name] = []
        for t in range(t_.shape[1]):
            pos = n if (name == "decode" and t == t_.shape[1] - 1) else t
            lo, cache = one.decode_step(model, cache, torch.from_numpy(t_[:, t:t + 1]).cuda(),
                                        torch.tensor(pos, dtype=torch.int32, device="cuda:0"))
            steps[name].append(lo.cpu().numpy())
    table = model.embed.table.detach().cpu().numpy()
    for r, g in enumerate(got):
        scale = float(np.max(np.abs(want)))
        assert float(np.max(np.abs(g["prefill"] - want))) <= LEAF_REL * scale, (arch, r)
        assert np.array_equal(g["embed"], table[toks]), (arch, r)
        for name in ("decode", "long"):
            for a, b in zip(g[name], steps[name]):
                assert float(np.max(np.abs(a - b))) <= LEAF_REL * float(np.max(np.abs(b))), (
                    arch, r, name)
