"""WISK + LM on the PyTorch/CUDA port: geo-textual retrieval feeding a small
LM decode loop -- the framework's two halves working together (DESIGN.md
section 4).

1. Retrieval: build a WISK index over the ``fs`` profile (3,000 objects),
   freeze it into an ``IndexSnapshot`` and serve four MIX SKR queries.
2. Generation: each query's first retrieved object id, modulo the
   vocabulary (numpy's sign rule: an empty result's ``-1`` becomes
   ``vocab - 1``), prompts reduced ``tinyllama-1.1b``, which generates
   8 tokens greedily from a 64-slot KV cache.

The same sizes, seeds and steps as ``examples/retrieval_augmented_serving.py``
(the JAX package's); the weights are drawn from a seeded ``torch.Generator``.
Everything runs on ``--device`` (``cuda`` by default; ``cpu`` runs the plain
PyTorch versions).

    PYTHONPATH=src python examples/torch_retrieval_augmented_serving.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.build import BuildConfig, build_wisk
from repro_torch.core.partition import PartitionConfig
from repro_torch.data.synth import make_dataset
from repro_torch.data.workloads import make_workload
from repro_torch.serve.engine import IndexSnapshot, retrieve_workload
from repro_torch.train.decode import greedy_generate
from repro_torch.train.step import build_steps

ARCH = "tinyllama-1.1b"
B, S, N_NEW = 4, 64, 8


def retrieve_prompts(snap, queries, max_leaves: int, vocab: int):
    """The SKR hits and the prompt: each query's first id modulo ``vocab``."""
    hits = retrieve_workload(snap, queries, max_leaves=max_leaves)
    prompt = (np.asarray(hits["ids"])[:, :1] % vocab).astype(np.int32)
    return hits, prompt


def generate(steps, params, prompt: np.ndarray, n_new: int = N_NEW, seq: int = S):
    """Greedy tokens (B, n_new) from a zero cache of ``seq`` slots."""
    cache = steps.init_cache(prompt.shape[0], seq)
    toks, _ = greedy_generate(steps, params, cache, torch.from_numpy(prompt).to(steps.device),
                              n_new=n_new, start_pos=0)
    return toks.cpu().numpy()


def main(device="cuda"):
    # 1) retrieval: SKR queries over the geo-textual corpus
    ds = make_dataset("fs", n=3000, seed=0)
    train = make_workload(ds, m=48, dist="MIX", seed=1)
    art = build_wisk(ds, train, BuildConfig(partition=PartitionConfig(max_clusters=24, n_steps=40)),
                     device=device)
    snap = IndexSnapshot.build(art.index, ds, device=device)
    queries = make_workload(ds, m=B, dist="MIX", seed=9)
    cfg = get_config(ARCH).reduced()
    hits, prompt = retrieve_prompts(snap, queries, art.partition.clusters.k, cfg.vocab)
    print("retrieved per query:", np.asarray(hits["counts"]).tolist())

    # 2) generation: retrieved object ids prompt a small LM
    steps = build_steps(cfg, device=device)
    dev = steps.device
    state = steps.init_state(torch.Generator(device=dev).manual_seed(0))
    toks = generate(steps, state["params"], prompt)
    print("generated token ids:", toks.tolist())
    print(f"device: {dev}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
