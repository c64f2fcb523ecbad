"""End to end: train an LM under Cocktail-scheduled non-IID data
(the port's copy of the JAX package's ``examples/train_lm_cocktail.py``).

The default model is small (minitron-family, ~7M parameters at the default
flags, 120 steps); a larger run is the same command with bigger flags:

    PYTHONPATH=src python -m repro_torch.examples.train_lm_cocktail [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm_cocktail \\
        --d-model 640 --layers 10 --vocab 50048 --steps 300 --batch 16

It shows scheduler-driven batch composition with |D_j| sample weighting
(paper eq. 15), heterogeneous-EC straggler handling, and checkpoint /
auto-resume: stop it mid-run and run the same command again. Runs on the
CUDA card unless ``--device`` names another device.
"""
import argparse
import dataclasses

from repro_torch.configs import base, get_config
from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=320)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--checkpoint-dir", default="build/cocktail_lm_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # a custom-size dense config (minitron family, scaled), registered by name
    cfg = dataclasses.replace(
        get_config("minitron-4b"),
        name="lm-example",
        n_layers=args.layers, d_model=args.d_model,
        n_heads=max(args.d_model // 64, 2), n_kv_heads=max(args.d_model // 128, 1),
        head_dim=64, d_ff=args.d_model * 3, vocab_size=args.vocab,
        head_pad_multiple=1, remat=False,
        param_dtype="float32", compute_dtype="float32",
    )
    base.register(cfg)
    print(f"model: {cfg.n_params()/1e6:.1f}M params")

    summary = train_mod.main([
        "--arch", "lm-example", "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--checkpoint-dir", args.checkpoint_dir,
        "--scheduler", "ds", "--device", args.device,
    ])
    if not summary["last_loss"] < summary["first_loss"]:
        raise SystemExit(f"loss did not decrease: {summary['first_loss']:.3f} -> "
                         f"{summary['last_loss']:.3f}")
    print(f"loss {summary['first_loss']:.3f} -> {summary['last_loss']:.3f} OK")
    return summary


if __name__ == "__main__":
    main()
