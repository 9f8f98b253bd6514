"""Dry run of every (architecture x input-shape) on one H100: does the
step fit one card, at what batch, and how far from its bound does it run.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --flash-kernel
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
        --shape train_4k --reduced --device cpu --seq-len 64 --batch 2

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
pair on a TPU mesh and reads the roofline from the compiled artifact.
Here one pair goes in three steps:

a. **Without allocating**: the stand-ins (:mod:`.input_specs`), the
   parameter counts, the analytic FLOPs (:mod:`.analytic_model`) and the
   weight, optimizer-state and cache bytes.  Where the float32 weights
   alone (x4 for AdamW training: params, gradients, mu, nu) exceed one
   card, the status is ``needs_cards`` with those bytes and the cards they
   need, and nothing runs; ``n_layers`` runs such a pair depth-cut
   instead, listing the cut under ``reduced`` beside the full-depth status.
   ``long_500k`` on a full-attention config is ``skipped``.
b. **On the device**: one real step at full width through the port's own
   entry points, on random float32 weights from ``seed``:
   ``build_train_step`` (one AdamW micro-step of one silo, micro-batch
   ``per_silo // accum`` with ``accum = per_silo // 16``, as the
   reference's single-pod run), ``build_prefill_step``, or
   ``build_decode_step`` at position ``seq_len - 1`` against a full bf16
   cache.  The batch starts at the reference's per-device figure (the
   micro-batch, or the shape's global batch) and halves on
   ``torch.cuda.OutOfMemoryError``; the record keeps every batch that
   failed, and the largest that ran is the per-card batch.  If batch 1
   fails too, the status is ``needs_cards``.  On the card it measures the
   step's wall after a warm-up (host clock around work that ends in a
   synchronise), the peak (``max_memory_allocated``), the device-busy time
   of one ``torch.profiler`` window and the share of the bound
   (:mod:`.roofline`); on the CPU those fields hold ``"not measured"``.
   With ``flash_kernel`` prefill attention goes through K3.
c. One JSON per pair under ``out`` (``<arch>_<shape>_1-h100.json``), with
   status ``ok``, ``needs_cards``, ``skipped`` or ``error`` (with the
   traceback's tail).

Importing this module sets nothing; entry points run on ``cuda`` unless
``device`` says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, shape_supported
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import input_specs as IS
from repro_torch.launch.analytic_model import analytic_step_flops
from repro_torch.launch.roofline import (HBM_BYTES, NOT_MEASURED, make_roofline,
                                         model_flops_estimate)
from repro_torch.models import ModelConfig, count_params, model_specs
from repro_torch.models.params import tree_leaves_with_path

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments_torch",
                           "dryrun")
MESH_NAME = "1xh100"
PARAM_BYTES = 4  # float32 weights
TRAIN_COPIES = 4  # params, gradients, AdamW's mu and nu
SKIP_REASON = ("full attention: long_500k requires sub-quadratic decode (a sliding window "
               "or a recurrent state)")
MEASURED = ("step_s", "warm_up_s", "steps_s", "peak_bytes", "peak_gib")


def active_param_count(cfg: ModelConfig) -> float:
    """Parameters touched per token: the full count less the routed
    experts outside the top-k (the MoE 6*N_active*D convention)."""
    total = 0.0
    for path, leaf in tree_leaves_with_path(model_specs(cfg)):
        n = float(math.prod(leaf.shape))
        if cfg.moe is not None and "moe" in path and any(
                k in ("w_gate", "w_up", "w_down") for k in path):
            n *= cfg.moe.top_k / cfg.moe.n_experts
        total += n
    return total


def result_path(out: str, arch: str, shape: str) -> str:
    return os.path.join(out, f"{arch}_{shape}_{MESH_NAME.replace('x', '-')}.json")


def start_batch(cfg: ModelConfig, spec: Dict[str, Any]) -> int:
    """The reference's per-device batch: the training micro-batch of one
    silo (``per_silo // accum``, ``accum = max(1, per_silo // 16)``), or
    the serving shape's global batch."""
    if spec["kind"] == "train":
        per = spec["global_batch"] // max(cfg.n_silos, 1)
        accum = max(1, per // 16)
        return per // accum
    return spec["global_batch"]


def fit_bytes(cfg: ModelConfig, kind: str) -> int:
    """float32 weights, x4 for AdamW training: what must fit one card
    before anything else does."""
    n = count_params(model_specs(cfg)) * PARAM_BYTES
    return n * TRAIN_COPIES if kind == "train" else n


def step_bytes(cfg: ModelConfig, spec: Dict[str, Any], batch: int) -> Dict[str, int]:
    """Bytes a step must move at ``batch``, each input read once and each
    output written once: training reads and writes params, mu and nu and
    reads its tokens and labels; prefill reads the weights and the prompt
    and writes the bf16 cache and the last logits; decode reads the
    weights, the cache and the token and writes the logits (the one slot
    it writes into the cache is left out)."""
    kind, S = spec["kind"], spec["seq_len"]
    weights = count_params(model_specs(cfg)) * PARAM_BYTES
    ins = IS.tree_bytes(step_inputs(cfg, spec, batch))
    if kind == "train":
        return {"weights": weights, "optimizer": 2 * weights, "inputs": ins, "cache": 0,
                "outputs": 0, "moved": 2 * 3 * weights + ins}
    logits = batch * cfg.vocab_size * 4
    cache = IS.tree_bytes(IS.abstract_cache(cfg, batch, S))
    if kind == "prefill":
        return {"weights": weights, "optimizer": 0, "inputs": ins, "cache": cache,
                "outputs": cache + logits, "moved": weights + ins + cache + logits}
    return {"weights": weights, "optimizer": 0, "inputs": ins, "cache": cache,
            "outputs": logits, "moved": weights + cache + ins + logits}


def step_inputs(cfg: ModelConfig, spec: Dict[str, Any], batch: int) -> Dict[str, Any]:
    """Stand-ins of the step's inputs at ``batch`` sequences of
    ``spec["seq_len"]``: one silo's one local step of ``batch`` sequences
    for training, the serving inputs otherwise (the decode cache apart)."""
    spec = dict(spec, global_batch=batch)
    if spec["kind"] == "train":
        return IS.train_input_specs(dataclasses.replace(cfg, n_silos=1), spec)
    ins = IS.serve_input_specs(cfg, spec)
    ins.pop("cache", None)
    return ins


def materialise(tree, dev: torch.device, gen: torch.Generator, vocab: int):
    """Random device tensors in the shapes of a stand-in tree: token ids
    below ``vocab``, normal features."""
    if isinstance(tree, dict):
        return {k: materialise(v, dev, gen, vocab) for k, v in tree.items()}
    if tree.dtype == IS.TOKEN_DT:
        return torch.randint(vocab, tuple(tree.shape), generator=gen, device=dev)
    return torch.randn(tuple(tree.shape), generator=gen, device=dev, dtype=tree.dtype)


def full_cache(cfg: ModelConfig, batch: int, max_len: int, dev: torch.device) -> List[Any]:
    """A bf16 serving cache as a prefill of ``max_len - 1`` tokens leaves
    it, but zero: every slot's ``pos`` set (a ring buffer's to the last
    positions), an encoder-decoder's cross K/V allocated."""
    cache = [_on(c, dev) for c in IS.abstract_cache(cfg, batch, max_len)]
    upto = max_len - 1

    def fill(node):
        if isinstance(node, dict):
            if "pos" in node:
                size = node["pos"].numel()
                p = torch.arange(max(0, upto - size), upto, device=dev)
                node["pos"][p % size] = p.to(node["pos"].dtype)
            for v in node.values():
                fill(v)
    for c in cache:
        fill(c)
    return cache


def _on(node, dev):
    if isinstance(node, torch.Tensor):
        fill = -1 if node.dtype == torch.int32 else 0
        return torch.full(tuple(node.shape), fill, dtype=node.dtype, device=dev)
    if isinstance(node, dict):
        return {k: _on(v, dev) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_on(v, dev) for v in node)
    return node


def _builder(cfg: ModelConfig, spec: Dict[str, Any], dev: torch.device, seed: int):
    """``make(b) -> run`` for the pair's step: the weights (and training
    state) are made once, ``make`` makes a batch's inputs and ``run``
    takes one step and returns its output (the loss, or the logits)."""
    from repro_torch.fed import init_state
    from repro_torch.launch.steps import (build_decode_step, build_prefill_step,
                                          build_train_step)
    from repro_torch.models import init_params
    from repro_torch.optim import adamw

    kind, S = spec["kind"], spec["seq_len"]
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    if kind == "train":
        opt = adamw(1e-4)
        state = init_state(cfg, opt, seed=seed, device=dev)
        step = build_train_step(cfg, optimizer=opt)

        def make(b):
            batch = materialise(step_inputs(cfg, spec, b), dev, gen, cfg.vocab_size)
            return lambda: step(state, batch)[1]["loss"]
        return make
    params = init_params(model_specs(cfg), seed=seed, device=dev)
    if kind == "prefill":
        step = build_prefill_step(cfg, max_len=S)

        def make(b):
            batch = materialise(step_inputs(cfg, spec, b), dev, gen, cfg.vocab_size)
            return lambda: step(params, batch)[0]
        return make
    step = build_decode_step(cfg)

    def make(b):
        batch = {"token": torch.randint(cfg.vocab_size, (b,), generator=gen, device=dev),
                 "cache": full_cache(cfg, b, S, dev), "position": S - 1}
        return lambda: step(params, batch)[0]
    return make


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run_halving(make, batches: List[int], dev: torch.device, *, reps: int = 2,
                profile: bool = True) -> Dict[str, Any]:
    """Take the pair's step at each batch of ``batches`` in turn until one
    runs without ``torch.cuda.OutOfMemoryError``: a warm-up step, ``reps``
    timed steps and, on the card, one profiled step.  Returns the batch
    that ran (None if none did), the batches that failed with the error's
    first line, whether the output was finite and, on the card, the
    timings and the peak."""
    from repro_torch.launch.profile_round import device_profile

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    failed: List[Dict[str, Any]] = []
    for b in batches:
        _free(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        run = None
        try:
            run = make(b)
            sync()
            t0 = time.perf_counter()
            out = run()
            finite = bool(torch.isfinite(out).all())
            sync()
            warm = time.perf_counter() - t0
            if not cuda:
                return {"batch": b, "failed": failed, "finite": finite, "steps_run": 1}
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                run()
                sync()
                times.append(time.perf_counter() - t0)
            prof = device_profile(run, dev)[1] if profile else {}
            peak = torch.cuda.max_memory_allocated(dev)
            return {"batch": b, "failed": failed, "finite": finite, "warm_up_s": warm,
                    "steps_s": times, "step_s": sorted(times)[len(times) // 2] if times else warm,
                    "peak_bytes": peak, "profile": prof, "steps_run": 1 + reps + bool(profile)}
        except torch.cuda.OutOfMemoryError as e:
            failed.append({"batch": b, "error": str(e).strip().splitlines()[0][:300]})
        finally:
            run = None
    _free(dev)
    return {"batch": None, "failed": failed, "finite": None}


def dryrun_one(arch: str, shape_name: str, *, device: DeviceLike = "cuda",
               out: Optional[str] = None, n_layers: Optional[int] = None, reduced: bool = False,
               seq_len: Optional[int] = None, batch: Optional[int] = None,
               flash_kernel: bool = False, seed: int = 0, reps: int = 2,
               profile: bool = True) -> Dict[str, Any]:
    """One (arch, shape) pair (see the module docstring); the record is
    returned and, with ``out``, written as JSON there.  ``n_layers`` cuts
    the depth, ``reduced`` takes the config's tiny CPU variant, ``seq_len``
    and ``batch`` cut the shape's sequence and the starting batch: each
    cut is listed under ``reduced``.  ``flash_kernel`` sends prefill
    attention through K3."""
    t0 = time.time()
    spec = dict(INPUT_SHAPES[shape_name])
    kind = spec["kind"]
    overrides: Dict[str, Any] = {"n_silos": 1}
    if flash_kernel and kind == "prefill":
        overrides["use_flash_kernel"] = True
    full = get_config(arch, **overrides)
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": MESH_NAME,
                              "kind": kind, "status": "?", "reduced": []}
    if not shape_supported(full, shape_name):
        result.update(status="skipped", reason=SKIP_REASON)
        return _save(result, out)
    cfg = full
    if reduced:
        cfg = dataclasses.replace(cfg.reduced(), n_silos=1,
                                  use_flash_kernel=full.use_flash_kernel)
        result["reduced"].append(f"reduced config: d_model {cfg.d_model}, {cfg.n_layers} layers "
                                 f"(full: d_model {full.d_model}, {full.n_layers})")
    if n_layers is not None and n_layers < cfg.n_layers:
        result["reduced"].append(f"n_layers {n_layers} of {cfg.n_layers}")
        cfg = dataclasses.replace(cfg, n_layers=n_layers, block_pattern=cfg.block_pattern[:n_layers])
    if seq_len is not None and seq_len != spec["seq_len"]:
        result["reduced"].append(f"seq_len {seq_len} of {spec['seq_len']}")
        spec["seq_len"] = seq_len
    first = start_batch(cfg, spec)
    if batch is not None and batch != first:
        result["reduced"].append(f"start batch {batch} of {first}")
        first = batch
    S = spec["seq_len"]
    full_fit = fit_bytes(full, kind)
    result["full_depth"] = {"n_layers": full.n_layers, "fit_bytes": full_fit,
                            "cards_needed": math.ceil(full_fit / HBM_BYTES),
                            "status": "needs_cards" if full_fit > HBM_BYTES else "fits"}
    n_active = active_param_count(cfg)
    fit = fit_bytes(cfg, kind)
    result.update(
        n_layers=cfg.n_layers, d_model=cfg.d_model, seq_len=S, start_batch=first,
        use_flash_kernel=cfg.use_flash_kernel, n_params=count_params(model_specs(cfg)),
        n_params_active=n_active, analytic_gflops_step=analytic_step_flops(cfg, spec, kind) / 1e9,
        fit_bytes=fit, cards_needed=math.ceil(fit / HBM_BYTES),
        bytes=step_bytes(cfg, spec, first))
    if fit > HBM_BYTES:
        result.update(status="needs_cards", reason=(
            f"float32 weights{' x4 (params, gradients, mu, nu)' if kind == 'train' else ''} "
            f"{fit / 1e9:.1f} GB exceed one card's {HBM_BYTES / 1e9:.0f} GB"),
            seconds=round(time.time() - t0, 2))
        return _save(result, out)
    dev = resolve_device(device)  # raises without the device: no fallback
    result["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev))
    try:
        batches = [first]
        while dev.type == "cuda" and batches[-1] > 1:
            batches.append(batches[-1] // 2)
        try:
            make = _builder(cfg, spec, dev, seed)
        except torch.cuda.OutOfMemoryError as e:
            _free(dev)
            result.update(status="needs_cards", failed_batches=[], oom=[{
                "batch": None, "error": str(e).strip().splitlines()[0][:300]}],
                reason="the weights ran out of memory on the card",
                seconds=round(time.time() - t0, 2))
            return _save(result, out)
        ran = run_halving(make, batches, dev, reps=reps, profile=profile)
        make = None
        _free(dev)
        result.update(failed_batches=[f["batch"] for f in ran["failed"]], oom=ran["failed"],
                      batch=ran["batch"], finite=ran["finite"], steps_run=ran.get("steps_run", 0))
        if ran["batch"] is None:
            result.update(status="needs_cards", reason="batch 1 ran out of memory on the card",
                          seconds=round(time.time() - t0, 2))
            return _save(result, out)
        b = ran["batch"]
        run_spec = dict(spec, global_batch=b)
        moved = step_bytes(cfg, spec, b)
        measured = None
        if "step_s" in ran:
            measured = {"step_s": ran["step_s"]}
            prof = ran.get("profile") or {}
            if prof.get("idle_share") is not None:
                measured.update(device_busy_s=prof["busy_s"], idle_share=prof["idle_share"],
                                parts_s=prof["parts_s"])
            result.update(step_s=ran["step_s"], warm_up_s=ran["warm_up_s"],
                          steps_s=ran["steps_s"], peak_bytes=ran["peak_bytes"],
                          peak_gib=ran["peak_bytes"] / 2 ** 30,
                          device_kernels=(sum(c for _, c, _ in prof["kernels"]) if prof
                                          else NOT_MEASURED))
        else:
            result.update({k: NOT_MEASURED for k in MEASURED})
        roof = make_roofline(arch=arch, shape=shape_name, batch=b,
                             flops=analytic_step_flops(cfg, run_spec, kind),
                             bytes_moved=moved["moved"],
                             model_flops=model_flops_estimate(run_spec, n_active, kind),
                             measured=measured)
        result.update(status="ok" if ran["finite"] else "error", bytes=moved,
                      roofline=json.loads(roof.to_json()), seconds=round(time.time() - t0, 2))
        if not ran["finite"]:
            result["error"] = "the step's output is not finite"
    except Exception as e:  # the record says what failed; the caller decides
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:],
                      seconds=round(time.time() - t0, 2))
    return _save(result, out)


def _save(result: Dict[str, Any], out: Optional[str]) -> Dict[str, Any]:
    print(summary_line(result), flush=True)
    if out:
        os.makedirs(out, exist_ok=True)
        with open(result_path(out, result["arch"], result["shape"]), "w") as f:
            json.dump(result, f, indent=2)
    return result


def summary_line(r: Dict[str, Any]) -> str:
    head = f"{r['arch']:22s} {r['shape']:12s}"
    st = r["status"]
    if st == "skipped":
        return f"[SKIP] {head} {r['reason']}"
    if st == "needs_cards":
        return (f"[CARDS] {head} {r.get('reason', '')}: {r.get('cards_needed')} cards; "
                f"batches failed {r.get('failed_batches', [])}")
    if st != "ok":
        return f"[ERR ] {head} {r.get('error', '?')}"
    roof = r["roofline"]
    peak = r["peak_gib"]
    step = r["step_s"]
    measured = not isinstance(step, str)
    return (f"[OK  ] {head} batch {r['batch']} (failed {r['failed_batches']}) "
            f"peak {peak if not measured else f'{peak:.2f}'} GiB step "
            f"{step if not measured else f'{step:.4f}'} s  bound {roof['bound_ms']:.3f} ms "
            f"({roof['bottleneck']}; compute {roof['compute_ms']:.3f}, tf32 "
            f"{roof['compute_tf32_ms']:.3f}, memory {roof['memory_ms']:.3f})  share "
            f"{roof['share'] if not measured else format(roof['share'], '.3f')}"
            + ("" if not r.get("reduced") else f"  reduced {r['reduced']}"))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true", help="every (arch x shape) in this process")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--flash-kernel", action="store_true",
                    help="prefill attention through the flash_attention kernel (K3)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (a needs_cards pair then runs, listed under reduced)")
    ap.add_argument("--reduced", action="store_true", help="the config's tiny CPU variant")
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None, help="starting batch")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    kw = dict(device=args.device, out=args.out, n_layers=args.n_layers, reduced=args.reduced,
              seq_len=args.seq_len, batch=args.batch, flash_kernel=args.flash_kernel,
              reps=args.reps, seed=args.seed)
    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        pairs = [(args.arch, args.shape)]
    failures = 0
    for arch, shape in pairs:
        r = dryrun_one(arch, shape, **kw)
        if r["status"] == "error":
            failures += 1
            print(r.get("traceback", ""), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
