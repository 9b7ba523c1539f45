"""MASt3R's fused forward on the card, before and after `chip_smoke.py`'s
detector phase in the same process.

    python -m lvdgs_torch.tools.net_timing

Run from the root of a checkout on a CUDA card. It builds the kernels, puts
`MASt3RConfig()` with random weights (seed 0) on the card and, on two
street frames at 512x144 as `chip_smoke.py`'s network phase does, times
the fused forward and the unfused pair it replaces in 3 blocks of 10
calls: each call's device time (CUDA events) and the host's time
to issue it, as minimum, median and maximum per block. It times them
fresh and after `chip_smoke.run_detector` (full-width GroundingDINO and
SAM, the 20-frame detector street), with the allocator's retries,
segments and memory beside each. Where the host's issue time matches the
device time, the call is host-bound and its time follows the host.
"""
from __future__ import annotations

import gc
import os
import sys
import time

import torch

from ..ops import rasterizer_cuda as rc
from .timing import card_line

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BLOCKS, REPS = 3, 10


def spread(fn, reps: int):
    """(device ms, host ms) of `reps` calls of fn(), each sorted; one
    call first as warm-up."""
    fn()
    dev, host = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        fn()
        end.record()
        host.append(1e3 * (time.perf_counter() - t))
        end.synchronize()
        dev.append(start.elapsed_time(end))
    return sorted(dev), sorted(host)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("net_timing needs a CUDA card")
    sys.path.insert(0, ROOT)
    import chip_smoke

    from ..core.config import load_config
    from ..data.datasets import load_dataset
    from ..models.mast3r import inference
    from ..models.mast3r import model as mm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(f"card: {card_line()}", flush=True)
    rc.build_libraries(False)
    rc.load_kernels()
    net = inference.MASt3RInference(mm.init_params(mm.MASt3RConfig(), torch.Generator(device=device).manual_seed(0),
                                                   device))
    config = load_config(os.path.join(ROOT, "configs/mono/synthetic/street.yaml"))
    ds = load_dataset(None, "", config, device)
    x1, shape = net._batch(ds[0][0])
    x2, _ = net._batch(ds[5][0])

    def report(when: str) -> None:
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()
        for b in range(BLOCKS):
            for name, fn in (("fused forward", lambda: mm.mast3r_forward_fused(net.model, x1, x2)),
                             ("unfused pair", lambda: (mm.mast3r_forward(net.model, x1, x2),
                                                       mm.mast3r_forward(net.model, x2, x2)))):
                dev, host = spread(fn, REPS)
                print(f"{when}, block {b}, {name} at {shape[1]}x{shape[0]}: device min {dev[0]:.3f} median "
                      f"{dev[len(dev) // 2]:.3f} max {dev[-1]:.3f} ms; host issue median {host[len(host) // 2]:.3f} "
                      f"ms", flush=True)
        after = torch.cuda.memory_stats()
        print(f"{when}: allocator retries {after['num_alloc_retries'] - before['num_alloc_retries']}, segments "
              f"allocated {after['segment.all.allocated'] - before['segment.all.allocated']}, "
              f"{after['allocated_bytes.all.current'] / 2**30:.2f} GiB allocated, "
              f"{after['reserved_bytes.all.current'] / 2**30:.2f} GiB reserved; {len(gc.get_objects())} objects "
              f"tracked by gc", flush=True)

    report("fresh")
    chip_smoke.run_detector(device, 20)  # chip_smoke.py's street length
    report("after the detector phase")


if __name__ == "__main__":
    main()
