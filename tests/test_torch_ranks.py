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
