"""Ranks for the port's multi-rank tests; this module holds no tests of its own.

``RankPool`` starts ``world`` processes with ``torch.multiprocessing``
(``spawn``) that join one gloo process group through a ``file://``
rendezvous, their meshes on the CPU (or all on one CUDA device) (so parallel test workers never share a port), and
keeps them for a module's tests. ``pool.run(task, *args)`` sends every rank
the same call -- the port's SPMD model: every rank makes the same
front-door call on the same batch -- and returns each rank's result, or
raises with the traceback of any rank that failed. Every collective has the
group's timeout and every wait on a result its own, so a deadlock fails one
test and does not hang the suite.

The tasks below run in the ranks. This module imports no JAX, so the ranks
start with torch and the port alone; the test files compare what the ranks
return with the JAX package in the main process.
"""
from __future__ import annotations

import datetime
import queue
import traceback

import torch

GROUP_TIMEOUT_S = 60
RESULT_TIMEOUT_S = 240


class RankPool:
    """``world`` ranks in one gloo group, fed tasks through queues."""

    def __init__(self, world: int, rendezvous: str, device: str = "cpu") -> None:
        ctx = torch.multiprocessing.get_context("spawn")
        self.world = world
        self.broken = False
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.procs = [
            ctx.Process(target=_rank_main,
                        args=(r, world, rendezvous, device, self.tasks[r], self.results),
                        daemon=True)
            for r in range(world)
        ]
        for p in self.procs:
            p.start()

    def run(self, task: str, *args, timeout: float = RESULT_TIMEOUT_S):
        """Every rank runs ``task(ctx, *args)``; returns the results in rank
        order, or raises when a rank failed or did not answer in time (a
        failed rank ends, so the pool is broken for later tasks)."""
        if self.broken:
            raise AssertionError(f"{task}: the ranks stopped at an earlier failure")
        for q in self.tasks:
            q.put((task, args))
        got = {}
        for _ in range(self.world):
            try:
                rank, ok, payload = self.results.get(timeout=timeout)
            except queue.Empty:
                self.broken = True
                dead = [r for r, p in enumerate(self.procs) if not p.is_alive()]
                raise AssertionError(f"{task}: no answer within {timeout} s (dead ranks {dead})")
            if not ok:
                self.broken = True
                raise AssertionError(f"{task} failed on rank {rank}:\n{payload}")
            got[rank] = payload
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)


class _Ctx:
    """A rank's state across tasks: its device and its meshes, one per
    layout (creating a mesh is collective, and every rank runs the same
    tasks in order)."""

    def __init__(self, device: str) -> None:
        self.device = device
        self.meshes = {}

    def mesh(self, query: int, index: int):
        from repro_torch.launch.mesh import make_serving_mesh

        key = (query, index)
        if key not in self.meshes:
            self.meshes[key] = make_serving_mesh(query=query, index=index, device=self.device)
        return self.meshes[key]

    def host_mesh(self, data: int, model: int):
        """The ``("data", "model")`` mesh of ``data`` x ``model`` ranks."""
        from repro_torch.launch.mesh import make_host_mesh

        key = ("host", data, model)
        if key not in self.meshes:
            self.meshes[key] = make_host_mesh(data=data, model=model, device=self.device)
        return self.meshes[key]


def _rank_main(rank, world, rendezvous, device, tasks, results) -> None:
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=rendezvous, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    ctx = _Ctx(device)
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            name, args = item
            try:
                results.put((rank, True, globals()[name](ctx, *args)))
            except Exception:  # report it to the test, then stop this rank
                results.put((rank, False, traceback.format_exc()))
                raise
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------------------------------- the tasks
def serve(ctx, layout, front_door, args, kw, repeat=1):
    """``front_door(*args, mesh=..., plan_cache=cache, **kw)`` ``repeat``
    times on one fresh ``PlanCache``: the outputs and the learned widths."""
    from repro_torch.launch import wisk_serve
    from repro_torch.serve.plan import PlanCache

    cache = PlanCache()
    fn = getattr(wisk_serve, front_door)
    outs = [fn(*args, mesh=ctx.mesh(*layout), plan_cache=cache, **kw) for _ in range(repeat)]
    return outs, dict(cache.widths)


def flat_step(ctx, layout, q_rects, q_bm, leaves, kw):
    """``wisk_serve_step`` on this rank's query and leaf rows (the
    ``query`` and ``leaf`` rules of the mesh), summed over its index axis;
    the whole batch's outputs gathered over the data axis."""
    from repro_torch.launch.flat_legacy import wisk_serve_step
    from repro_torch.sharding.rules import shard_rows

    mesh = ctx.mesh(*layout)
    rows = [shard_rows(t, "leaf", mesh) for t in leaves]
    out = wisk_serve_step(shard_rows(q_rects, "query", mesh), shard_rows(q_bm, "query", mesh),
                          *rows, axis=mesh.axis("index"), **kw)
    return [mesh.axis("data").all_gather(t).reshape(-1).numpy() for t in out]


def mesh_info(ctx, layout):
    mesh = ctx.mesh(*layout)
    return dict(rank=mesh.rank, shape=mesh.shape,
                coords={n: mesh.axis(n).index for n in mesh.axis_names})


def agree(ctx, layout, by_rank):
    """``ServingMesh.agree`` on ``by_rank[rank]``: None, or the message it
    raised."""
    mesh = ctx.mesh(*layout)
    try:
        mesh.agree(by_rank[mesh.rank], "a test value")
    except RuntimeError as e:
        return str(e)
    return None


def live(ctx, layout, steps, live_kw):
    """A ``LiveIndex(index_shards=...)`` on the layout's mesh through
    ``steps`` (see ``run_live_steps``); the outputs of every step."""
    from repro_torch.launch.wisk_serve import LiveIndex

    li = LiveIndex(index_mesh=ctx.mesh(*layout), device="cpu", **live_kw)
    assert li.generation.partitioned is not None
    return run_live_steps(li, steps)


def run_live_steps(li, steps):
    """Drive a ``LiveIndex`` through ``steps``: ``("serve", rects, bms,
    max_leaves)``, ``("knn", points, bms, k)``, ``("insert", locs, kw_ids)``,
    ``("delete", ids)`` or ``("rebuild", force)``; returns each step's
    result (with the generation's ``seq`` after it)."""
    out = []
    for step in steps:
        op, args = step[0], step[1:]
        if op == "serve":
            got = li.serve(*args)
        elif op == "knn":
            got = li.serve_knn(*args)
        elif op == "insert":
            got = li.insert(*args)
        elif op == "delete":
            got = li.delete(*args)
        else:
            got = li.maybe_rebuild(force=args[0])
        out.append((op, got, li.generation.seq))
    return out



def moe_layer(ctx, layout, cfg, params, x, dtype="float32"):
    """``moe_ffn(..., mesh)`` on the ``("data", "model")`` mesh ``layout``:
    ``params`` and ``x`` are whole numpy f32 arrays, of which the rank takes
    its blocks (the expert stacks where ``ep_sharded``, ``x``'s rows), all
    but the router in ``dtype``. Returns the rank's output rows (as f32)
    and the census of its collectives."""
    from repro_torch.launch.mesh import collective_census
    from repro_torch.models import moe
    from repro_torch.sharding.rules import default_rules, shard_tensor

    mesh = ctx.host_mesh(*layout)
    rules = default_rules(mesh)
    names = dict(w_gate=("experts", "wembed", "expert_mlp"),
                 w_up=("experts", "wembed", "expert_mlp"),
                 w_down=("experts", "expert_mlp", "wembed"))
    dt = getattr(torch, dtype)
    p = {k: torch.from_numpy(v).to(torch.float32 if k == "w_router" else dt)
         if not isinstance(v, dict) else {n: torch.from_numpy(a).to(dt) for n, a in v.items()}
         for k, v in params.items()}
    if moe.ep_sharded(cfg, mesh):
        p.update({k: shard_tensor(p[k], n, mesh, rules).contiguous() for k, n in names.items()})
    x_loc = shard_tensor(torch.from_numpy(x).to(dt), ("batch", None, None), mesh, rules)
    with torch.no_grad(), collective_census() as census:
        y = moe.moe_ffn(p, x_loc, cfg, mesh)
    return y.float().numpy(), census.bytes, census.counts


def lm_steps(ctx, layout, cfg, seed, tokens, n_decode):
    """``build_steps(cfg, mesh=...)`` on the layout's mesh, the state drawn
    from ``seed`` on the CPU: ``prefill_step`` on ``tokens`` (the whole
    batch) and ``n_decode`` decode steps of its columns into a fresh cache.
    Returns this rank's prefill logits, its decode logits and the censuses
    of the prefill and of one decode step."""
    from repro_torch.launch.mesh import collective_census
    from repro_torch.train.step import build_steps

    mesh = ctx.host_mesh(*layout)
    steps = build_steps(cfg, mesh=mesh)
    params = steps.init_state(torch.Generator().manual_seed(seed))["params"]
    toks = torch.from_numpy(tokens)
    with collective_census() as pre:
        logits = steps.prefill_step(params, dict(tokens=toks))
    cache = steps.init_cache(toks.shape[0], n_decode)
    dec = []
    for t in range(n_decode):
        with collective_census() as step:
            lo, cache = steps.decode_step(params, cache, toks[:, t:t + 1],
                                          torch.tensor(t, dtype=torch.int32))
        dec.append(lo.numpy())
    return logits.numpy(), dec, pre.bytes, step.bytes


def _carry(steps, model, values):
    """Load this rank's blocks of the whole numpy parameters ``values``
    (the reference's nested tree) into ``model``."""
    from repro_torch.models.convert import params_from_reference

    model.load_state_dict(params_from_reference(
        values, shardings=lambda name: steps.placement(model.specs[name])))


def _names(tree, prefix=""):
    """The dotted names of ``tree.leaves(tree)``, in its order."""
    from torch import nn

    from repro_torch.tree import module_tree

    if isinstance(tree, nn.Module):
        tree = module_tree(tree)
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [n for f, v in zip(tree._fields, tree) for n in _names(v, f"{prefix}{f}.")]
    return [prefix[:-1]]


def _state_blocks(steps, state):
    """The state's leaves (``tree.leaves`` order) as ``(name, numpy,
    slices)``: each with the slices of the whole leaf it is this rank's
    block of."""
    from repro_torch.tree import leaves

    out = []
    for name, x, sh in zip(_names(state), leaves(state), leaves(steps.state_shardings())):
        x = x.detach()
        out.append((name, x.cpu().numpy().copy(), sh.index(sh.global_shape(x.shape))))
    return out


def lm_train(ctx, layout, cfg, values, batches):
    """``build_steps(cfg, mesh=...)`` on the layout's mesh, its parameters
    this rank's blocks of ``values``, one ``train_step`` per whole batch of
    ``batches``. Returns each step's ``(loss, grad_norm)``, each step's
    census ``(bytes, counts)`` and the final state's blocks."""
    from repro_torch.launch.mesh import collective_census
    from repro_torch.train.step import build_steps

    steps = build_steps(cfg, mesh=ctx.host_mesh(*layout))
    state = steps.init_state(torch.Generator().manual_seed(0))
    _carry(steps, state["params"], values)
    metrics, censuses = [], []
    for b in batches:
        b = {k: torch.from_numpy(v).to(steps.device) for k, v in b.items()}
        with collective_census() as census:
            state, m = steps.train_step(state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"]), float(m["lr"])))
        censuses.append((census.bytes, census.counts))
    return metrics, censuses, _state_blocks(steps, state)


def moe_grads(ctx, layout, cfg, params, x, c):
    """The gradients of ``sum(moe_ffn(params, x, cfg, mesh) * c)`` on the
    layout's mesh, each input this rank's block (``moe_layer``'s): with
    respect to its rows of ``x``, the router (summed over the data ranks,
    as ``train_step`` sums a whole leaf's gradient) and its expert
    blocks."""
    from repro_torch.models import moe
    from repro_torch.sharding.rules import default_rules, shard_tensor

    mesh = ctx.host_mesh(*layout)
    rules = default_rules(mesh)
    names = dict(w_gate=("experts", "wembed", "expert_mlp"),
                 w_up=("experts", "wembed", "expert_mlp"),
                 w_down=("experts", "expert_mlp", "wembed"))
    t = torch.from_numpy
    p = {k: t(v) if not isinstance(v, dict) else {n: t(a) for n, a in v.items()}
         for k, v in params.items()}
    p.update({k: shard_tensor(p[k], n, mesh, rules).contiguous() for k, n in names.items()})
    for k in ("w_router", *names):
        p[k].requires_grad_(True)
    x_loc = shard_tensor(t(x), ("batch", None, None), mesh, rules).contiguous().requires_grad_()
    c_loc = shard_tensor(t(c), ("batch", None, None), mesh, rules)
    y = moe.moe_ffn(p, x_loc, cfg, mesh)
    got = torch.autograd.grad((y * c_loc).sum(), [x_loc, p["w_router"], *(p[k] for k in names)])
    out = dict(zip(["x", "w_router", *names], (g.numpy() for g in got)))
    out["w_router"] = mesh.axis("data").psum(torch.from_numpy(out["w_router"])).numpy()
    return out


def ckpt_save(ctx, layout, cfg, values, batches, ckpt_dir):
    """``lm_train``'s steps on the layout's mesh, then the state saved to
    ``ckpt_dir`` through ``AsyncCheckpointer(shardings=...)`` (whole leaves,
    rank 0 writing). Returns the saved state's blocks."""
    from repro_torch.ckpt.checkpoint import AsyncCheckpointer
    from repro_torch.train.step import build_steps

    steps = build_steps(cfg, mesh=ctx.host_mesh(*layout))
    state = steps.init_state(torch.Generator().manual_seed(0))
    _carry(steps, state["params"], values)
    for b in batches:
        state, _ = steps.train_step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    ckpt = AsyncCheckpointer(ckpt_dir, shardings=steps.state_shardings())
    ckpt.submit(len(batches), state)
    ckpt.close()
    return _state_blocks(steps, state)


def ckpt_submits(ctx, layout, cfg, ckpt_dir, n):
    """``n`` submits of the initial state at steps 1..n through one
    ``AsyncCheckpointer(shardings=...)`` on the layout's mesh (more than
    its queue holds), then ``close``. Returns the rank."""
    from repro_torch.ckpt.checkpoint import AsyncCheckpointer
    from repro_torch.train.step import build_steps

    steps = build_steps(cfg, mesh=ctx.host_mesh(*layout))
    state = steps.init_state(torch.Generator().manual_seed(0))
    ckpt = AsyncCheckpointer(ckpt_dir, shardings=steps.state_shardings())
    for step in range(1, n + 1):
        ckpt.submit(step, state)
    ckpt.close()
    return steps.mesh.rank


def ckpt_restore_remeshed(ctx, n_devices, cfg, ckpt_dir, batch):
    """``plan_remesh(n_devices).make_mesh()`` over the first ranks (the
    others return None): the latest checkpoint restored onto it with
    ``restore(..., shardings=)``, then one ``train_step`` on ``batch``.
    Returns the plan's shape, the restored blocks, the step's metrics and
    the stepped blocks."""
    from repro_torch.ckpt.checkpoint import restore
    from repro_torch.resilience.elastic import plan_remesh
    from repro_torch.train.step import build_steps

    plan = plan_remesh(n_devices)
    mesh = plan.make_mesh(device=ctx.device)
    if mesh is None:
        return None
    steps = build_steps(cfg, mesh=mesh)
    state, step = restore(ckpt_dir, steps.init_state(torch.Generator()),
                          shardings=steps.state_shardings())
    restored = _state_blocks(steps, state)
    state, m = steps.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return plan.shape, step, restored, (float(m["loss"]), float(m["grad_norm"])), _state_blocks(
        steps, state)


def lm_loop(ctx, layout, cfg, tc_kw):
    """``train(cfg, TrainConfig(**tc_kw), mesh=...)`` on the layout's mesh:
    its losses, the step it restored from and its step times."""
    from repro_torch.train.loop import TrainConfig, train

    r = train(cfg, TrainConfig(**tc_kw), mesh=ctx.host_mesh(*layout))
    return r.losses, r.restored_from, r.step_times


def collective_grads(ctx, layout):
    """The collectives' backward on the layout's mesh, at inputs that
    name their rank: ``psum`` over ``model`` (its cotangent passes
    through), ``pvary`` (its cotangents summed), ``all_gather`` over
    ``model`` (reduce-scattered). Returns each result and gradient on the
    host, and the census."""
    from repro_torch.launch.mesh import collective_census

    mesh = ctx.host_mesh(*layout)
    model = mesh.axis("model")
    dev = mesh.device
    r = float(mesh.rank + 1)
    x = torch.full((3, 4), r, device=dev, requires_grad=True)
    c = torch.arange(12.0, device=dev).reshape(3, 4) * r
    with collective_census() as census:
        y = model.psum(x)
        gp, = torch.autograd.grad((y * c).sum(), [x])
        v = model.pvary(x)
        gv, = torch.autograd.grad((v * c).sum(), [x])
        g = model.all_gather(x)
        cg = torch.arange(float(g.numel()), device=dev).reshape(g.shape) * r
        ga, = torch.autograd.grad((g * cg).sum(), [x])
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return dict(y=host(y), gp=host(gp), gv=host(gv), g=host(g), ga=host(ga),
                census=(census.bytes, census.counts))


# ------------------------------------ the rules' layout (tests/test_torch_layout_*)
def _first_mesh(ctx, layout):
    """The ``("data", "model")`` mesh of ``layout`` over the pool's first
    ranks (None on the others; creating it is collective, so every rank
    calls this)."""
    from repro_torch.launch.mesh import make_host_mesh

    key = ("first", *layout)
    if key not in ctx.meshes:
        ctx.meshes[key] = make_host_mesh(*layout, device=ctx.device, first=True)
    return ctx.meshes[key]


def _f32_cache(cache):
    """A cache in f32 (the decode then rounds nothing to bf16 on the way)."""
    return {k: v.float() for k, v in cache.items()}


def layout_serve(ctx, layout, cfg, seed, tokens, dec_tokens, n_slots, long_tokens, n_long):
    """``build_steps(cfg, mesh=...)`` on the pool's first ranks in
    ``layout``, the parameters drawn from ``seed`` on the CPU: the prefill
    of ``tokens`` (a dict: the whole batch), the embedding of its tokens
    through the model's ``embed_lookup``, decode steps of ``dec_tokens``'
    columns at positions 0, 1, ... into an f32 cache of ``n_slots`` slots
    and one more at position ``n_slots`` (the clamp past the end), and
    long-context decode steps of ``long_tokens`` (one row) into ``n_long``
    slots over every rank. Returns this rank's outputs (the logits of its
    rows, whole vocabulary), the censuses of the prefill and of each decode
    step, and its parameter bytes; None on the ranks outside the mesh."""
    from repro_torch.launch.mesh import collective_census
    from repro_torch.models import layers as L
    from repro_torch.train.step import build_steps

    mesh = _first_mesh(ctx, layout)
    if mesh is None:
        return None
    steps = build_steps(cfg, mesh=mesh)
    dev = steps.device
    model = steps.init_state(torch.Generator().manual_seed(seed))["params"]
    batch = {k: torch.as_tensor(v).to(dev) for k, v in tokens.items()}
    with collective_census() as pre:
        logits = steps.prefill_step(model, batch)
    rows = steps.local(dict(tokens=batch["tokens"]), dict(tokens=("batch", None)))["tokens"]
    with torch.no_grad():
        emb = L.embed_lookup(dict(table=model.embed.table), rows, model.lay)
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    out = dict(prefill=host(logits), prefill_census=(pre.bytes, pre.counts),
               embed=host(emb), param_bytes=sum(p.numel() * p.element_size()
                                                for p in model.parameters()))
    dec = torch.from_numpy(dec_tokens).to(dev)
    B = dec.shape[0]
    for name, toks, n, long_ctx in (("decode", dec, n_slots, False),
                                    ("long", torch.from_numpy(long_tokens).to(dev), n_long,
                                     True)):
        cache = _f32_cache(steps.init_cache(toks.shape[0], n, long_ctx))
        positions = list(range(toks.shape[1]))
        if not long_ctx:
            positions[-1] = n  # past the end: the last slot
        got, censuses = [], []
        for t, pos in enumerate(positions):
            with collective_census() as step:
                lo, cache = steps.decode_step(model, cache, toks[:, t:t + 1],
                                              torch.tensor(pos, dtype=torch.int32, device=dev),
                                              long_ctx)
            got.append(host(lo))
            censuses.append((step.bytes, step.counts))
        out[name] = got
        out[f"{name}_census"] = censuses
        out[f"{name}_cache"] = {k: host(v) for k, v in cache.items()}
    out["rows"] = B // layout[0]
    return out


def layout_grads(ctx, layout, cfg, values, batch):
    """The gradients of one training step (``step_gradients``: the global
    batch's mean loss) on the pool's first ranks in ``layout``, the
    parameters this rank's blocks of ``values``: the loss and each
    parameter's gradient block ``(name, numpy, slices)``; and the rank's
    state and batch bytes. None outside the mesh."""
    from repro_torch.train.step import build_steps, step_gradients
    from repro_torch.tree import leaves

    mesh = _first_mesh(ctx, layout)
    if mesh is None:
        return None
    steps = build_steps(cfg, mesh=mesh)
    state = steps.init_state(torch.Generator().manual_seed(0))
    _carry(steps, state["params"], values)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, grads = step_gradients(steps, state["params"], b)
    out = []
    for name, g, sh in zip(_names(state["params"]), grads,
                           leaves(steps.state_shardings()["params"])):
        out.append((name, g.detach().numpy().copy(), sh.index(sh.global_shape(g.shape))))
    local = steps.local(b, {k: ("batch",) for k in b})
    nbytes = sum(x.numel() * x.element_size() for x in leaves(state) + list(local.values()))
    return float(loss), out, nbytes


def layout_family(ctx, layout, cfg, values, batch, decodes):
    """Every step of ``build_steps(cfg, mesh=...)`` on the pool's first
    ranks in ``layout``, the parameters this rank's blocks of ``values``
    (the reference's nested tree, whole): the prefill of ``batch`` (whole
    tensors); for each ``(name, cache, tokens, positions, n_slots,
    long_ctx)`` of ``decodes`` (``cache`` whole, of ``n_slots`` slots, taken
    as this rank's blocks) a decode step of each column of ``tokens`` at
    its position; the gradients of ``step_gradients`` on ``batch``; then
    one ``train_step`` on it. Returns this rank's logits, the census of
    each step, the final cache blocks, the gradient blocks ``(name, numpy,
    slices)`` with the loss, and the bytes the dry run counts: the state's,
    and per decode the parameters', the cache's as ``init_cache`` makes it
    and the token rows'. None outside the mesh."""
    from repro_torch.launch.mesh import collective_census
    from repro_torch.train.step import build_steps, step_gradients
    from repro_torch.tree import leaves

    mesh = _first_mesh(ctx, layout)
    if mesh is None:
        return None
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    steps = build_steps(cfg, mesh=mesh)
    state = steps.init_state(torch.Generator().manual_seed(0))
    model = state["params"]
    _carry(steps, model, values)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    with collective_census() as pre:
        logits = steps.prefill_step(model, b)
    out = dict(prefill=host(logits), prefill_census=(pre.bytes, pre.counts),
               param_bytes=nbytes(model.parameters()), rows=b["tokens"].shape[0] // layout[0])
    for name, whole, tokens, positions, n_slots, long_ctx in decodes:
        toks = torch.from_numpy(tokens)
        B = toks.shape[0]
        _, specs = steps.cache_spec(B, n_slots, long_ctx)
        native = steps.init_cache(B, n_slots, long_ctx)
        cache = {k: v.clone() for k, v in steps.local(
            {k: torch.from_numpy(v) for k, v in whole.items()}, specs).items()}
        assert all(cache[k].shape == native[k].shape for k in native), name
        got, censuses = [], []
        for t, pos in enumerate(positions):
            with collective_census() as step:
                lo, cache = steps.decode_step(model, cache, toks[:, t:t + 1],
                                              torch.tensor(pos, dtype=torch.int32), long_ctx)
            got.append(host(lo))
            censuses.append((step.bytes, step.counts))
        step_toks = toks[:, :1]
        tok_rows = step_toks if long_ctx else steps.local(dict(t=step_toks),
                                                          dict(t=("batch", None)))["t"]
        out[name] = dict(logits=got, censuses=censuses,
                         cache={k: host(v) for k, v in cache.items()},
                         bytes=(out["param_bytes"], nbytes(native.values()), nbytes([tok_rows])))
    with collective_census() as census:
        loss, grads = step_gradients(steps, model, b)
    out["grads_census"] = (census.bytes, census.counts)
    out["loss"] = float(loss)
    out["grads"] = [(name, host(g).copy(), sh.index(sh.global_shape(g.shape)))
                    for name, g, sh in zip(_names(model), grads,
                                           leaves(steps.state_shardings()["params"]))]
    out["state_bytes"] = nbytes(leaves(state))
    del grads
    with collective_census() as census:
        steps.train_step(state, b)
    out["train_census"] = (census.bytes, census.counts)
    return out
