"""Batched decode serving example (the port's copy of the JAX package's
``examples/serve_decode.py``): KV-cache generation on a reduced config of
any architecture (ring-buffer caches for sliding-window archs, recurrent
state for SSM archs, a cross-attention cache for the encoder-decoder).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch mixtral-8x7b --device cpu

Runs on the CUDA card unless ``--device`` names another device.
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve.main(["--arch", args.arch, "--reduced", "--batch", str(args.batch),
                       "--gen", str(args.gen), "--device", args.device])


if __name__ == "__main__":
    main()
