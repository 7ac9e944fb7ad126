"""Device selection for the port's entry points."""

import torch


def resolve_device(name=None):
    """torch.device for an entry point: the CUDA card unless `name` asks
    for something else ("cpu", "cuda:1"). With no card and no explicit
    "cpu" this raises; there is no silent CPU fallback."""
    if name is None or name == "cuda" or str(name).startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; the port runs on the GPU unless "
                "asked for the CPU (--device cpu)")
        return torch.device(name or "cuda")
    return torch.device(name)
