"""The port's leg of ``examples/serve_batch.py``: prefill a batch of
prompts, then greedy-decode continuations with the cache machinery of
every config (attention caches, ring buffers, RG-LRU and RWKV states), on
a reduced config with seeded parameters.

    PYTHONPATH=src python -m repro_torch.launch.serve_batch [--arch rwkv6-3b] [--device cpu]

It is ``launch.serve``'s LM path with the example's defaults; it runs on
the card unless ``--device cpu``.
"""

import argparse

from repro_torch.launch.serve import serve_lm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-27b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return serve_lm(argparse.Namespace(**vars(args), reduced=True, seed=0, ckpt_dir=""))


if __name__ == "__main__":
    main()
