"""Roofline assembly: three terms per (arch x shape x mesh) from the port's
dry-run records (``launch/dryrun.py``) -- the JAX package's
``roofline/analysis.py`` in H100 terms.

Hardware model: one NVIDIA H100 SXM a rank (NVIDIA's H100 data sheet, SXM
part, dense rates): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of
HBM3. The ``model`` axis stays inside one 8-GPU NVLink node (NVLink 4:
450 GB/s a direction a GPU); the data axes cross nodes over a DGX H100
node's eight 400 Gb/s ConnectX-7 links, one a GPU (50 GB/s).

Terms (seconds, per step, per rank):
  compute    = traced matmul FLOPs / PEAK_FLOPS
  memory     = traced bytes (eager PyTorch's, every op's reads and writes)
               / HBM_BW; the analytic napkin bytes are reported beside
  collective = the census's bytes on ``model`` / NVLINK_BW + its bytes on
               the data axes / NET_BW

The traced FLOPs are each rank's own program's (``roofline/op_stats.py``):
eager code runs every op, so there is no while-body undercount to correct.
Every family computes each tensor-parallel layer's share on each
``model`` rank (the rules' layout); what the layout runs alike on every
``model`` rank (whisper's attention, xLSTM's recurrences) counts n times
over a ``model`` axis of n ranks, which ``useful`` (MODEL_FLOPS over the
traced FLOPs of every rank) shows. MODEL_FLOPS uses 6*N*D (dense) /
6*N_active*D (MoE), as the reference.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

from ..configs import get_config
from ..configs.base import SHAPES

PEAK_FLOPS = 989e12  # bf16 dense, per H100 SXM (NVIDIA H100 data sheet)
HBM_BW = 3.35e12  # B/s per H100 SXM (HBM3; NVIDIA H100 data sheet)
NVLINK_BW = 450e9  # B/s a direction per GPU (NVLink 4, 900 GB/s both ways; data sheet)
NET_BW = 50e9  # B/s per GPU: one 400 Gb/s ConnectX-7 link a GPU in a DGX H100 node


def param_counts(cfg) -> Dict[str, float]:
    """(total_params, active_params_per_token) analytic estimate."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    H = cfg.pad_heads_to or cfg.n_heads
    hd, KV = cfg.head_dim, cfg.n_kv_heads
    emb = V * d * 2  # embed + head
    per_attn = d * H * hd + 2 * d * KV * hd + H * hd * d
    if cfg.use_mla:
        per_attn = (
            d * cfg.q_lora + cfg.q_lora * H * (cfg.qk_nope + cfg.qk_rope)
            + d * (cfg.kv_lora + cfg.qk_rope)
            + cfg.kv_lora * H * (cfg.qk_nope + cfg.v_head)
            + H * cfg.v_head * d
        )
    per_dense_ffn = 3 * d * cfg.d_ff
    fe = cfg.d_expert or cfg.d_ff
    per_expert = 3 * d * fe
    per_shared = 3 * d * fe * cfg.n_shared_experts

    total = emb
    total_active = 0.0
    if cfg.family == "encdec":
        total += cfg.enc_layers * (per_attn + 2 * d * cfg.d_ff)
        total += L * (2 * per_attn + 2 * d * cfg.d_ff)
        total_active = total
    elif cfg.family == "xlstm":
        di = cfg.d_inner
        per_m = d * 2 * di + 3 * di * di / cfg.n_heads + di * 2 * cfg.n_heads + di * d
        per_s = 2 * d * 4 * d + d * d
        n_s = L // cfg.slstm_every
        total += (L - n_s) * per_m + n_s * per_s
        total_active = total
    elif cfg.family == "hybrid":
        di = cfg.d_inner
        per_mamba = d * 2 * di + di * (cfg.dt_rank + 2 * cfg.d_state) + cfg.dt_rank * di + di * d
        n_attn = L // cfg.attn_every
        n_moe = L // cfg.moe_every if cfg.n_experts else 0
        n_dense_ffn = L - n_moe
        total += (L - n_attn) * per_mamba + n_attn * per_attn
        total += n_dense_ffn * per_dense_ffn + n_moe * cfg.n_experts * per_expert
        total_active = total - n_moe * cfg.n_experts * per_expert + n_moe * cfg.moe_topk * per_expert
    elif cfg.n_experts:
        n_moe = L - cfg.first_dense
        total += L * per_attn + cfg.first_dense * per_dense_ffn
        total += n_moe * (cfg.n_experts * per_expert + per_shared)
        total_active = (
            emb + L * per_attn + cfg.first_dense * per_dense_ffn
            + n_moe * (cfg.moe_topk * per_expert + per_shared)
        )
    else:
        total += L * (per_attn + per_dense_ffn)
        total_active = total
    return dict(total=float(total), active=float(total_active))


def model_flops(cfg, shape_name: str) -> float:
    """MODEL_FLOPS global per step: 6*N_active*D train, 2*N_active*D prefill,
    2*N_active*B decode (one token per sequence)."""
    seq, batch, kind = SHAPES[shape_name]
    n_act = param_counts(cfg)["active"]
    if kind == "train":
        return 6.0 * n_act * seq * batch
    if kind == "prefill":
        return 2.0 * n_act * seq * batch
    return 2.0 * n_act * batch  # decode: one new token per sequence


def analytic_hbm_bytes(cfg, shape_name: str, n_chips: int) -> float:
    """Per-chip HBM traffic napkin model (stated, conservative):

    train:   3x param-shard reads (fwd + remat-recompute + bwd) + grad write
             + optimizer state read/write + 2 passes over saved activations.
    prefill: 1x param reads + activation write/read once.
    decode:  1x param reads + full KV-cache shard read + O(1) writes.
    """
    seq, batch, kind = SHAPES[shape_name]
    pc = param_counts(cfg)
    p_shard = pc["total"] * 2 / n_chips  # bf16 storage spread over all chips
    d = cfg.d_model
    tokens_local = seq * batch / max(n_chips / 16, 1) / 16  # dp shards only
    if kind == "train":
        opt_mult = 8 if cfg.optimizer == "adamw" else 1  # f32 m+v r/w vs factored
        act = 2 * cfg.n_layers * tokens_local * d * 2  # saved layer inputs, 2 passes
        return 3 * p_shard + p_shard + opt_mult * p_shard * 2 + act
    if kind == "prefill":
        act = 2 * cfg.n_layers * tokens_local * d * 2
        return p_shard + act
    # decode: cache shard dominates
    if cfg.use_mla:
        cache = cfg.n_layers * batch * seq * (cfg.kv_lora + cfg.qk_rope) * 2
    elif cfg.family == "xlstm":
        H = cfg.n_heads
        dh = cfg.d_inner // H
        cache = cfg.n_layers * batch * (H * dh * dh) * 4
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        cache = n_attn * batch * seq * cfg.n_kv_heads * cfg.head_dim * 2 * 2
        cache += (cfg.n_layers - n_attn) * batch * cfg.d_inner * cfg.d_state * 4
    else:
        cache = cfg.n_layers * batch * seq * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    return p_shard + cache / n_chips + pc["active"] * 2 / n_chips


def collective_seconds(by_axis: Dict[str, Dict[str, int]]) -> float:
    """The census's bytes per rank priced by the links their axis crosses:
    ``model`` alone over NVLink, any axis with a data axis in it over the
    network."""
    t = 0.0
    for axis, by_op in by_axis.items():
        bw = NVLINK_BW if set(axis.split(",")) <= {"model"} else NET_BW
        t += sum(by_op.values()) / bw
    return t


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    traced_flops_global: float
    useful_ratio: float
    analytic_memory_s: float
    seconds: Optional[float] = None  # the cell's dry run, where --all timed it
    note: str = ""


def roofline_from_record(rec: Dict, cfg=None) -> Optional[RooflineRow]:
    if "skipped" in rec or rec.get("arch") == "wisk":
        return None
    arch, shape = rec["arch"], rec["shape"]
    cfg = cfg or get_config(arch)
    chips = rec["devices"]
    census = rec["op_census"]
    flops_dev = float(census["flops"])
    mf = model_flops(cfg, shape)
    traced_global = flops_dev * chips
    compute = flops_dev / PEAK_FLOPS
    memory = census["bytes"] / HBM_BW
    collective = collective_seconds(rec.get("collective_bytes_by_axis", {}))
    terms = dict(compute=compute, memory=memory, collective=collective)
    return RooflineRow(
        arch=arch, shape=shape, compute_s=compute, memory_s=memory, collective_s=collective,
        bottleneck=max(terms, key=terms.get), model_flops=mf,
        traced_flops_global=traced_global,
        useful_ratio=(mf / traced_global) if traced_global else 0.0,
        analytic_memory_s=analytic_hbm_bytes(cfg, shape, chips) / HBM_BW,
        seconds=rec.get("seconds"),
    )


def load_rows(dryrun_dir: str, mesh: str = "data32xmodel8") -> List[RooflineRow]:
    rows = []
    for f in sorted(Path(dryrun_dir).glob(f"*_{mesh}.json")):
        rec = json.loads(f.read_text())
        if rec.get("mesh") != mesh:
            continue
        row = roofline_from_record(rec)
        if row:
            rows.append(row)
    return rows


def to_markdown(rows: List[RooflineRow]) -> str:
    hdr = (
        "| arch | shape | compute (ms) | memory (ms) | collective (ms) | bound | "
        "analytic memory (ms) | MODEL_FLOPS | traced FLOPs | useful | dry run (s) |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    out = [hdr]
    for r in rows:
        secs = "" if r.seconds is None else f"{r.seconds:.1f}"
        out.append(
            f"| {r.arch} | {r.shape} | {r.compute_s*1e3:.2f} | {r.memory_s*1e3:.2f} | "
            f"{r.collective_s*1e3:.2f} | **{r.bottleneck}** | {r.analytic_memory_s*1e3:.2f} | "
            f"{r.model_flops:.2e} | {r.traced_flops_global:.2e} | {r.useful_ratio:.2f} | "
            f"{secs} |\n"
        )
    return "".join(out)


def memory_markdown(dryrun_dir: str, mesh: str = "data32xmodel8") -> str:
    """Each LM cell's bytes a rank (GB): its arguments as placed and by the
    rules, the step's eager peak, and whether the arguments fit one card
    alone and with the peak beside them (the records' ``fits``)."""
    out = ["| arch | shape | as placed (GB) | by the rules (GB) | equal | peak live (GB) | "
           "fits | fits with peak |\n|---|---|---|---|---|---|---|---|\n"]
    for f in sorted(Path(dryrun_dir).glob(f"*_{mesh}.json")):
        rec = json.loads(f.read_text())
        if rec.get("mesh") != mesh or "memory" not in rec or rec.get("arch") == "wisk":
            continue
        m, fits = rec["memory"], rec["fits"]
        out.append(
            f"| {rec['arch']} | {rec['shape']} | {m['argument_bytes'] / 1e9:.2f} | "
            f"{m['rules_argument_bytes'] / 1e9:.2f} | "
            f"{m['argument_bytes'] == m['rules_argument_bytes']} | "
            f"{m['peak_live_bytes'] / 1e9:.2f} | {fits['argument_bytes']} | "
            f"{fits['with_peak_live_bytes']} |\n")
    return "".join(out)


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="data32xmodel8")
    args = ap.parse_args()
    print(to_markdown(load_rows(args.dir, args.mesh)))
    print(memory_markdown(args.dir, args.mesh))


if __name__ == "__main__":
    main()
