"""End-to-end LM training on the PyTorch/CUDA port: a ~100M-parameter
reduced ``tinyllama-1.1b`` for a few hundred steps with checkpoints and
straggler monitoring -- ``examples/train_lm.py`` (the JAX package's) on the
port.

The same model (8 layers, d_model 512, vocab 32,000 by default), batch
(4 x 256 tokens), checkpoint and log cadence; it trains on ``--device``
(``cuda`` by default; ``cpu`` runs the plain PyTorch versions). Run it
again with more ``--steps`` and the same ``--ckpt`` to resume from the
latest checkpoint.

    PYTHONPATH=src python examples/torch_train_lm.py [--device cpu] [--steps 200]
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.train.loop import TrainConfig, train


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()
    # ~100M params at the defaults: 8 layers x d=512 x vocab 32k
    cfg = dataclasses.replace(
        cfg, d_model=args.d_model, n_layers=args.layers, n_heads=8, n_kv_heads=4,
        head_dim=args.d_model // 8, d_ff=args.d_model * 3, vocab=32000,
    )
    tc = TrainConfig(n_steps=args.steps, batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt,
                     ckpt_every=50, log_every=20)
    res = train(cfg, tc, device=args.device)
    span = f", loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}" if res.losses else ""
    print(f"done on {args.device}: {len(res.losses)} steps{span}, "
          f"restored_from={res.restored_from}")


if __name__ == "__main__":
    main()
