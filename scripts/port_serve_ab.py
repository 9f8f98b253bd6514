#!/usr/bin/env python3
"""Serve h2o-danube-1.8b and internlm2-1.8b at full size through the
PyTorch port of one checkout, on one CUDA card, and print each run's
prefill seconds, decode tokens/s, peak device memory and K3 launches.

    python3 scripts/port_serve_ab.py PATH/TO/CHECKOUT [PATH/TO/CHECKOUT ...]

Each checkout runs in a process of its own (its kernels are built there,
from its own sources), after one untimed serve at the same shapes, with
the settings of ``chip_smoke.py``'s serve phase: random float32 weights
from seed 0, danube at batch 2 with an 8192-token prompt and 32 tokens,
internlm2 at batch 4 with a 1024-token prompt and 16 tokens, prefill
attention through the flash-attention kernel.  To compare two commits on
one card, unpack the parent beside the change and give the checkouts in
turns: parent, change, change, parent.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

RUNS = (("h2o-danube-1.8b", 2, 8192, 32), ("internlm2-1.8b", 4, 1024, 16))


def serve_checkout(root: Path) -> None:
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, _build, reset_launch_counts
    from repro_torch.launch.serve import serve
    from repro_torch.models import init_params, model_specs

    if not torch.cuda.is_available():
        raise SystemExit("port_serve_ab: no CUDA device")
    if not _build.CSRC.is_relative_to(root):
        raise SystemExit(f"port_serve_ab: imported the port from {_build.CSRC}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(["flash_attention"])
    dev = torch.device("cuda", 0)
    for arch, batch, prompt_len, gen in RUNS:
        cfg = get_config(arch, use_flash_kernel=True)
        params = init_params(model_specs(cfg), seed=0, device=dev)
        serve(cfg, batch=batch, prompt_len=prompt_len, gen=4, seed=0, device=dev,
              params=params, log=lambda line: None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        res = serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=0, device=dev,
                    params=params, log=lambda line: None)
        peak = torch.cuda.max_memory_allocated()
        print(f"serve_ab {root} {arch}: prefill {res.prefill_s:.4f} s  decode "
              f"{res.decode_tok_s:.2f} tok/s  peak {peak / 2**30:.4f} GiB  flash_attention "
              f"launches {LAUNCHES['flash_attention']}  ({torch.cuda.get_device_name(0)})",
              flush=True)
        del res, params
        torch.cuda.empty_cache()


def main(argv: list) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        serve_checkout(Path(argv[1]).resolve())
        return 0
    if not argv:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    for root in argv:
        done = subprocess.run([sys.executable, __file__, "--one", root])
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
