"""The port's DQN and packing environment against the JAX package.

The Q-network (``q_apply`` within 1e-5 at carried weights), one update fed
the reference's own replay indices (parameters within 1e-6, loss within
1e-5 relative), the masked random action (the j-th valid slot), the
environment math (exact on random action sequences, mask on and off) and
the greedy rollout of carried trained parameters (the reference's actions)
are held against the reference on the same numpy inputs. The port's two
rollout modes take the same draws and must agree bit for bit on the CPU:
actions, rewards, replay contents, losses and parameters.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dqn as jdqn  # noqa: E402
from repro.core import packing as jpack  # noqa: E402
from repro_torch.core import dqn as tdqn  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402


def _labels(seed=0, N=6, m=5):
    return np.random.default_rng(seed).integers(0, 2, (N, m)).astype(bool)


def _carry(ts):
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return tdqn.train_state_from_reference(tree(ts.params), tree(ts.target), tree(ts.opt_m),
                                           tree(ts.opt_v), int(ts.step), device="cpu")


def _reference_buffer(labels, cfg, key, eps=0.8, episodes=3):
    """A reference TrainState and replay after a few training episodes."""
    N, m = labels.shape
    key, k0 = jax.random.split(key)
    ts = jdqn.train_state_init(k0, (m + 1) * N + m, N, cfg.dqn)
    buf = jdqn.replay_init(cfg.dqn.capacity, (m + 1) * N + m, N)
    for _ in range(episodes):
        key, k = jax.random.split(key)
        _, _, buf, ts, _, _ = jpack._rollout_episode(jnp.asarray(labels), ts, buf, k, eps, cfg.dqn,
                                                     True, cfg.action_mask)
    return ts, buf, key


def _carry_buffer(buf):
    b = tdqn.replay_init(buf.s.shape[0], buf.s.shape[1], buf.mask2.shape[1])
    for f in ("s", "a", "r", "s2", "mask2", "done"):
        getattr(b, f).copy_(torch.as_tensor(np.array(getattr(buf, f))))
    b.ptr, b.size = int(buf.ptr), int(buf.size)
    return b


def test_q_apply_and_greedy_match_reference():
    for seed, (sd, na, h) in enumerate([(41, 6, 64), (300, 17, 8)]):
        jp = jdqn.q_init(jax.random.PRNGKey(seed), sd, na, h)
        net = tdqn.train_state_from_reference(*(jax.tree.map(np.asarray, jp),) * 4, 0).params
        s = np.random.default_rng(seed).integers(0, 2, (9, sd)).astype(np.float32)
        want = np.asarray(jdqn.q_apply(jp, jnp.asarray(s)))
        np.testing.assert_allclose(tdqn.q_apply(net, torch.as_tensor(s)).detach().numpy(), want,
                                   atol=1e-5, rtol=0)
        mask = np.random.default_rng(seed + 1).random((9, na)) < 0.5
        mask[:, 0] = True
        got = tdqn.greedy_action(net, torch.as_tensor(s), torch.as_tensor(mask)).numpy()
        np.testing.assert_array_equal(got, [int(jdqn.greedy_action(jp, jnp.asarray(x), jnp.asarray(k)))
                                            for x, k in zip(s, mask)])
    gen = torch.Generator().manual_seed(0)
    net = tdqn.q_init(gen, 41, 6)
    assert net.l0.weight.shape == (64, 41) and float(net.l0.bias.detach().abs().sum()) == 0.0


@pytest.mark.parametrize("step", [0, 7])
def test_dqn_update_with_reference_indices_matches(step):
    """One update from the same state and replay, fed the indices the
    reference's step draws: parameters within 1e-6, loss within 1e-5."""
    labels = _labels(2, N=8, m=6)
    cfg = jpack.PackingConfig(dqn=jdqn.DQNConfig(batch_size=8, capacity=64))
    ts, buf, key = _reference_buffer(labels, cfg, jax.random.PRNGKey(5))
    ts = ts._replace(step=jnp.asarray(step, jnp.int32))
    k = jax.random.PRNGKey(11)
    idx = np.array(jax.random.randint(k, (cfg.dqn.batch_size,), 0, jnp.maximum(buf.size, 1)))
    jts, jloss = jdqn.dqn_train_step(ts, buf, k, cfg.dqn)
    tts = _carry(ts)
    tcfg = tdqn.DQNConfig(batch_size=8, capacity=64)
    loss = tdqn.dqn_update(tts, _carry_buffer(buf), torch.as_tensor(idx, dtype=torch.int64), tcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = _carry(jts)
    assert int(tts.step) == int(want.step) == step + 1
    for net, ref in ((tts.params, want.params), (tts.target, want.target)):
        for (name, a), b in zip(net.named_parameters(), ref.parameters()):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6, rtol=0,
                                       err_msg=name)
    for k_ in tts.opt_m:
        np.testing.assert_allclose(tts.opt_m[k_].numpy(), want.opt_m[k_].numpy(), atol=1e-7, rtol=1e-5)


def test_masked_random_action_picks_the_jth_valid_slot():
    rng = np.random.default_rng(0)
    masks = rng.random((200, 13)) < 0.4
    masks[:3] = False
    masks[3:6] = True
    draws = rng.random(200).astype(np.float32)
    draws[:8] = np.float32(1.0) - np.float32(2.0 ** -24)  # the largest uniform below 1
    got = tdqn.masked_random_action(torch.as_tensor(draws), torch.as_tensor(masks)).numpy()
    for w, m, a in zip(draws, masks, got):
        valid = np.nonzero(m)[0]
        if valid.size == 0:
            assert a == 0
            continue
        j = min(int(w * np.float32(valid.size)), valid.size - 1)
        assert a == valid[j]
        assert a == int(tdqn.masked_random_action(torch.as_tensor(w), torch.as_tensor(m)))
    idx = tdqn.replay_indices(torch.as_tensor(draws), 37)
    assert int(idx.min()) >= 0 and int(idx.max()) == 36


@pytest.mark.parametrize("use_mask", [True, False])
def test_env_math_matches_reference_env(use_mask):
    """Random action sequences through the port's tensor transition (forced
    through the random-action draw) and numpy ``_Env``: the reference env's
    states and masks exactly, its access counts exactly, and rewards equal
    to (before - after) / m in f32."""
    rng = np.random.default_rng(3)
    for trial in range(4):
        labels = _labels(10 + trial, N=7, m=5)
        N, m = labels.shape
        _, _, transition = tpack._env_math(torch.as_tensor(labels), use_mask)
        ref, port = jpack._Env(labels, use_mask), tpack._Env(labels, use_mask)
        s_ref, s_port = ref.reset(), port.reset()
        upper = torch.zeros((1, N, m), dtype=torch.bool)
        counts = torch.zeros((1, N), dtype=torch.int64)
        for t in range(N):
            mask = ref.mask()
            np.testing.assert_array_equal(port.mask(), mask)
            valid = np.nonzero(mask)[0]
            j = int(rng.integers(valid.size))
            draw = torch.tensor([(j + 0.5) / valid.size], dtype=torch.float32)
            s, a, r, upper, counts, s2, mask2, done = _forced(transition, upper, counts,
                                                              torch.tensor([t]), draw)
            act = int(valid[j])
            assert int(a[0]) == act
            before = round(ref.avg_accesses() * m)
            assert before == port.access_count()
            np.testing.assert_array_equal(s[0].numpy(), s_ref)
            s_ref, r_ref, done_ref = ref.step(act)
            s_port, r_port, done_port = port.step(act)
            after = round(ref.avg_accesses() * m)
            assert after == port.access_count()
            assert r_port == np.float32(before - after) / np.float32(m) == float(r[0])
            assert abs(r_port - r_ref) < 1e-6
            np.testing.assert_array_equal(s_port, s_ref)
            np.testing.assert_array_equal(s2[0].numpy(), s_ref)
            assert bool(done) == done_ref == done_port
            np.testing.assert_array_equal(mask2[0].numpy(), np.zeros(N, bool) if done else ref.mask())


def _forced(transition, upper, counts, t, draw):
    """The transition with the random action forced (epsilon 1), so the
    draw picks the action; the greedy branch needs parameters, so feed any
    net of the right shape."""
    N, m = upper.shape[1:]
    net = tdqn.q_init(torch.Generator().manual_seed(0), (m + 1) * N + m, N)
    return transition(net, upper, counts, t, torch.zeros(1), draw, 1.0, True)


def test_greedy_rollout_of_carried_params_matches_reference():
    labels = _labels(4, N=9, m=7)
    cfg = jpack.PackingConfig(dqn=jdqn.DQNConfig(batch_size=8, capacity=64))
    ts, buf, key = _reference_buffer(labels, cfg, jax.random.PRNGKey(3), episodes=4)
    want, _, _, _, _, _ = jpack._rollout_episode(jnp.asarray(labels), ts, buf, key, 0.0, cfg.dqn,
                                                 False, True)
    tts = _carry(ts)
    tcfg = tpack.PackingConfig(dqn=tdqn.DQNConfig(batch_size=8, capacity=64))
    got, _, _, _ = tpack._Rollout(torch.as_tensor(labels), tts, None, tcfg.dqn, True).episode(
        None, 0.0, False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    seq, *_ = tpack._run_episode(tpack._Env(labels, True), tts, tdqn.replay_init(64, 1, 1), None,
                                 0.0, tcfg, train=False)
    np.testing.assert_array_equal(seq, np.asarray(want))


@pytest.mark.parametrize("eps,use_mask", [(0.7, True), (0.0, True), (1.0, False)])
def test_port_rollout_modes_agree_bit_for_bit(eps, use_mask):
    """Several training episodes through the batched rollout and the host
    loop from one init and one draw stream: the same actions, rewards,
    replay contents, losses and parameters, bit for bit."""
    labels = _labels(3, N=8, m=6)
    cfg = tpack.PackingConfig(epochs=4, action_mask=use_mask,
                              dqn=tdqn.DQNConfig(batch_size=8, capacity=64))
    N, m = labels.shape
    D = (m + 1) * N + m
    runs = []
    for mode in ("batched", "sequential"):
        gen = torch.Generator().manual_seed(1)
        ts = tdqn.train_state_init(gen, D, N, cfg.dqn)
        buf = tdqn.replay_init(cfg.dqn.capacity, D, N)
        acts, rews, losses = [], [], []
        rollout = tpack._Rollout(torch.as_tensor(labels), ts, buf, cfg.dqn, use_mask)
        for _ in range(3):
            draws = tpack._episode_draws(gen, (), N, cfg.dqn, "cpu")
            if mode == "batched":
                a, r, ls, trained = rollout.episode(draws, eps, True)
                a, r, ls = a.numpy(), r.numpy(), ls.numpy()[np.asarray(trained)].tolist()
            else:
                a, r, buf, ts, ls, _ = tpack._run_episode(tpack._Env(labels, use_mask), ts, buf,
                                                          draws, eps, cfg, train=True)
            acts.append(a)
            rews.append(r)
            losses.extend(ls)
        runs.append((acts, rews, losses, buf, ts))
    (a1, r1, l1, b1, t1), (a2, r2, l2, b2, t2) = runs
    np.testing.assert_array_equal(np.stack(a1), np.stack(a2))
    np.testing.assert_array_equal(np.stack(r1), np.stack(r2))
    assert l1 == l2 and len(l1) > 0
    for f in ("s", "a", "r", "s2", "mask2", "done"):
        assert torch.equal(getattr(b1, f), getattr(b2, f)), f
    assert (b1.ptr, b1.size) == (b2.ptr, b2.size)
    assert int(t1.step) == int(t2.step) > 0
    for x, y in zip(list(t1.params.parameters()) + list(t1.target.parameters()),
                    list(t2.params.parameters()) + list(t2.target.parameters())):
        assert torch.equal(x, y)


def test_pack_one_level_modes_agree_and_parallel_knob():
    labels = _labels(7, N=10, m=8)
    cfg = tpack.PackingConfig(epochs=6, dqn=tdqn.DQNConfig(batch_size=16, capacity=128))
    seq = tpack.pack_one_level(labels, cfg, seed=1, mode="sequential", device="cpu")
    bat = tpack.pack_one_level(labels, cfg, seed=1, mode="batched", device="cpu")
    np.testing.assert_array_equal(seq.assign, bat.assign)
    assert (seq.n_upper, seq.sum_rewards, seq.reward_curve, seq.losses, seq.n_env_steps) == (
        bat.n_upper, bat.sum_rewards, bat.reward_curve, bat.losses, bat.n_env_steps)
    assert len(seq.losses) > 0
    # the batched rollout waits on the device once an episode
    assert bat.n_dispatches == cfg.epochs + 1 < seq.n_dispatches
    par = tpack.pack_one_level(_labels(9, N=8, m=6), dataclasses.replace(cfg, epochs=3, parallel_episodes=4),
                               seed=2, mode="batched", device="cpu")
    assert par.assign.shape == (8,)
    assert par.assign.min() == 0 and par.assign.max() == par.n_upper - 1
    assert np.unique(par.assign).size == par.n_upper
    assert par.n_env_steps == (3 * 4 + 1) * 8 and len(par.reward_curve) == 12
    with pytest.raises(ValueError, match="mode"):
        tpack.pack_one_level(labels, cfg, mode="scan", device="cpu")


def test_spectral_group_and_hierarchy_match_reference():
    rng = np.random.default_rng(5)
    lo = rng.random((30, 2)).astype(np.float32)
    mbrs = np.concatenate([lo, lo + 0.05], 1)
    for g in (1, 4, 30):
        np.testing.assert_array_equal(tpack.spectral_group(mbrs, g, seed=3),
                                      jpack.spectral_group(mbrs, g, seed=3))
    labels = rng.random((30, 6)) < 0.3
    cfg = tpack.PackingConfig(epochs=2, spectral_ratio=0.2, dqn=tdqn.DQNConfig(batch_size=8, capacity=64))
    h = tpack.build_hierarchy(labels, mbrs, cfg, device="cpu")
    np.testing.assert_array_equal(h.parents[0], jpack.spectral_group(mbrs, 6, 0))
    assert len(h.parents) == len(h.packs) == len(h.level_labels) - 1
    for parent, lower, upper in zip(h.parents, h.level_labels, h.level_labels[1:]):
        assert parent.shape[0] == lower.shape[0] and parent.max() + 1 == upper.shape[0]
    assert h.n_env_steps == sum(p.n_env_steps for p in h.packs)
