"""Batched serving example on the PyTorch port: prefill a batch of prompts,
decode with the cache, on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu] \
        [--arch jamba-1.5-large-398b]

``repro_torch.launch.serve`` with the example's arch, the hybrid
jamba-1.5-large (reduced: a mamba2 layer and an attention layer with MoE),
as ``examples/serve_batched.py`` names it; every other flag is the
launcher's.
"""
import sys

from repro_torch.launch import serve

DEFAULT_ARCH = "jamba-1.5-large-398b"


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a == "--arch" or a.startswith("--arch=") for a in argv):
        argv += ["--arch", DEFAULT_ARCH]
    return serve.main(argv)


if __name__ == "__main__":
    main()
