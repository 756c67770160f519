"""Dry run: every (arch x input shape x mesh) cell's per-device memory,
FLOPs, bytes and collectives, and its roofline on H100s, reckoned on
meta tensors.

The port of the JAX package's `launch/dryrun.py`, which lowers and
compiles each cell's sharded step for 256 or 512 forced host devices and
reads memory, cost and collectives out of XLA. The port compiles
nothing: it reckons the same record on meta tensors, with nothing
allocated and no card needed. Where a field cannot be had the JAX way,
the record says how it was had (`method`):

- memory: `argument_gib` exactly, from the spec tables
  (`launch/sharding.py`): one device's share of the params, moments,
  batch and caches (every shard is alike: a dimension the axes do not
  divide stays whole). `output_gib` and `alias_gib` from what the step
  returns and donates: a train step its params and moments, updated in
  place, beside the f32 gradients it keeps in `.grad` (the port's
  step, not the JAX one, returns those: `held_after_gib` is what stays
  allocated after it); a decode step its caches. `temp_gib` is the peak
  of live bytes in a meta run of the step over one data shard's
  microbatch (`roofline/flops.py`): an upper bound over the model axis,
  whose activations (and a train step's gradients) it does not divide.
- cost: the step's global FLOPs, counted on meta tensors over the whole
  batch (`roofline/flops.py`), by dtype class, over the devices. No XLA
  `bytes accessed` exists: a train or prefill row's
  `bytes_per_device_est` is its resident bytes (arguments, outputs and
  temporaries less the aliased), as the JAX record's lower bound.
- analytic_traffic (decode): the JAX record's term, weights (in FP8
  the upper byte only) + cache reads (in FP8 the hi planes only) + one
  token's cache writes, over the devices.
- collectives: reckoned from the spec tables
  (`roofline/analysis.py::collective_bytes`), not parsed from HLO.
- roofline: `analysis.roofline_terms` at the H100 SXM5 constants;
  `useful_ratio` = model FLOPs / counted FLOPs.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape decode_32k --mesh single --mode fp16     # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
      # every ASSIGNED arch x INPUT_SHAPES cell, in this process; skips a
      # cell whose JSON exists unless --force
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")
GIB = 2 ** 30


def _scalar(path, shape, cfg, mesh):
    from repro_torch.launch import sharding as SH
    return SH.scalar_sharding(mesh)


def _data_shard_rows(mesh, rows: int) -> int:
    """Rows a data shard holds of a batch of `rows` (all of them when the
    data axes do not divide it, as `batch_spec` leaves it whole)."""
    from repro_torch.launch.mesh import data_axis_size
    dsz = data_axis_size(mesh)
    return rows // dsz if rows % dsz == 0 else rows


def _arg_bytes(trees, cfg, mesh) -> int:
    """One device's bytes of (tree, rule, kwargs) triples (a share
    reckoned once for the leaves that every layer of a list repeats)."""
    from repro_torch.launch import sharding as SH
    total = 0
    seen: dict = {}
    for tree, rule, kw in trees:
        for _, leaf, stack, spec in SH.tree_specs(tree, rule, cfg, mesh,
                                                  **kw):
            key = (spec, tuple(leaf.shape), leaf.dtype, stack)
            if key not in seen:
                seen[key] = SH.local_bytes(leaf, spec, mesh, stack)
            total += seen[key]
    return int(total)


def _inputs(cfg, shape, data_size: int, kv: str) -> dict:
    """The step's inputs as meta tensors: a train shape's params, AdamW
    state (bf16 moments for deepseek-v3, as the JAX dry run) and
    microbatched batch; a prefill's serving params and batch; a decode's
    serving params, caches, tokens and cache_len."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig(low_mem=(cfg.arch_id
                                             == "deepseek-v3-671b"))
        params = steps.param_structs(cfg, serving=False)
        return {"opt_cfg": opt_cfg, "params": params,
                "opt": steps.opt_structs(cfg, opt_cfg, params),
                "batch": steps.batch_specs(cfg, shape, data_size=data_size)}
    params = steps.param_structs(cfg, serving=True)
    batch = steps.batch_specs(cfg, shape, data_size=data_size)
    if shape.kind == "prefill":
        return {"params": params, "batch": batch}
    return {"params": params, "tokens": batch["tokens"],
            "cache_len": batch["cache_len"],
            "caches": steps.cache_structs(cfg, shape, planar=(kv == "planar"))}


def _arg_trees(inp: dict) -> list:
    """(tree, rule, kwargs) of each argument, as the JAX dry run shards
    it (`in_shardings`)."""
    from repro_torch.launch import sharding as SH
    trees = [(inp["params"], SH.param_spec, {})]
    if "opt" in inp:
        trees += [(inp["opt"]["m"], SH.opt_state_spec, {}),
                  (inp["opt"]["v"], SH.opt_state_spec, {}),
                  ({"step": inp["opt"]["step"]}, _scalar, {}),
                  (inp["batch"], SH.batch_spec, {"micro": True})]
    elif "batch" in inp:
        trees.append((inp["batch"], SH.batch_spec, {}))
    else:
        trees += [(inp["caches"], SH.cache_spec, {}),
                  ({"tokens": inp["tokens"]}, SH.batch_spec, {}),
                  ({"cache_len": inp["cache_len"]}, _scalar, {})]
    return trees


def argument_bytes(cfg, shape, mesh, kv: str = "f16") -> int:
    """One device's argument bytes of a cell, from the spec tables."""
    from repro_torch.launch.mesh import data_axis_size
    return _arg_bytes(_arg_trees(_inputs(cfg, shape, data_axis_size(mesh),
                                         kv)), cfg, mesh)


def _local_shape(shape, rows: int):
    """A data shard's own shape: `rows` rows (for a train shape, one
    microbatch of them)."""
    return dataclasses.replace(shape, global_batch=rows)


def _step(cfg, shape, mode: str, opt_cfg=None):
    from repro_torch.launch import steps
    if shape.kind == "train":
        return steps.make_train_step(cfg, opt_cfg)
    if shape.kind == "prefill":
        return steps.make_prefill_step(cfg, mode=mode, capacity=shape.seq_len)
    return steps.make_decode_step(cfg, mode)


def _call(fn, inp: dict):
    """fn on the inputs in its argument order, under a FLOP count."""
    from repro_torch.roofline import flops as fcount
    names = {"train": ("params", "opt", "batch"),
             "prefill": ("params", "batch"),
             "decode": ("params", "caches", "tokens", "cache_len")}
    kind = ("train" if "opt" in inp else "prefill" if "batch" in inp
            else "decode")
    return fcount.count(fn, *(inp[n] for n in names[kind]))


def reckon(cfg, shape, mesh, *, mode: str = "fp16", kv: str = "f16"
           ) -> dict:
    """The dry-run record's reckoned part of one cell: `cfg` stepping
    `shape` (an `InputShape`) on `mesh` (a `launch.mesh.Layout`)."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import data_axis_size
    from repro_torch.roofline import analysis as roof

    n_chips = mesh.size
    dsz = data_axis_size(mesh)
    rec: dict = {"devices": n_chips, "mesh_shape": mesh.shape,
                 "lower_s": None, "compile_s": None,
                 "method": "reckoned on meta tensors: nothing is lowered or "
                           "compiled"}
    t0 = time.time()
    inp = _inputs(cfg, shape, dsz, kv)
    trees = _arg_trees(inp)
    args = _arg_bytes(trees, cfg, mesh)
    counted = _call(_step(cfg, shape, mode, inp.get("opt_cfg")), inp)
    if shape.kind == "train":
        n_micro, mb = steps.micro_layout(shape, dsz)
        rows = max(mb // dsz, 1)             # a data shard's micro rows
        local = _inputs(cfg, _local_shape(shape, rows), rows, kv)
        donated = _arg_bytes(trees[:4], cfg, mesh)   # params, moments
        grads = _arg_bytes(trees[:1], cfg, mesh)     # f32, as the params
        outputs = donated + grads + 3 * 4      # + loss, grad_norm, lr
        coll = roof.collective_bytes(
            cfg, mesh, kind="train", tokens=rows * shape.seq_len, rows=rows,
            n_micro=n_micro, act_bytes=2, grad_bytes=grads, param_bytes=grads)
        extra = {"held_after_gib": (donated + grads) / GIB,
                 "grads_gib": grads / GIB}
    else:
        rows = _data_shard_rows(mesh, shape.global_batch)
        local = _inputs(cfg, _local_shape(shape, rows), 1, kv)
        logits, caches = counted.result
        out = [({"logits": logits}, SH.batch_spec, {})]
        if shape.kind == "prefill":
            out.append((caches, SH.cache_spec, {}))
            donated = 0
        else:
            donated = _arg_bytes(trees[1:2], cfg, mesh)   # the caches
        outputs = donated + _arg_bytes(out, cfg, mesh)
        tokens = rows * (shape.seq_len if shape.kind == "prefill" else 1)
        coll = roof.collective_bytes(
            cfg, mesh, kind=shape.kind, tokens=tokens, rows=rows, mode=mode,
            act_bytes=2, cache_context=(shape.kind == "decode" and dsz > 1
                                        and shape.global_batch % dsz != 0))
        extra = {}
    temp = _call(_step(cfg, shape, mode, inp.get("opt_cfg")), local)
    rec["reckon_s"] = time.time() - t0
    temp_bytes = temp.peak_temp_bytes
    rec["memory"] = {
        "argument_gib": args / GIB,
        "output_gib": outputs / GIB,
        "temp_gib": temp_bytes / GIB,
        "alias_gib": donated / GIB,
        "peak_gib": (args + outputs + temp_bytes - donated) / GIB,
        **extra,
        "method": ("arguments, outputs and aliases from the spec tables; "
                   "temp: peak live bytes of a meta run over one data "
                   "shard's microbatch, an upper bound over the model "
                   "axis (activations not divided)")}
    flops_global = counted.total
    flops = flops_global / n_chips
    rec["cost"] = {
        "flops_per_device": flops,
        "flops_per_device_xla_loops_once": None,
        "flops_global_jaxpr": flops_global,
        "bytes_per_device": None,
        "scan_lengths": [],
        "flops_global_by_class": dict(counted.by_class),
        "dot_flops_global_by_class": dict(counted.dot_by_class),
        "kernel_calls": dict(counted.kernel_calls),
        "method": "flops_global_jaxpr counted on meta tensors "
                  "(roofline/flops.py; the port has no scans); no XLA cost "
                  "analysis: bytes_per_device and the loops-once count "
                  "do not exist"}
    rec["collectives"] = coll
    resident = args + outputs + temp_bytes - donated
    bytes_est = float(resident)
    if shape.kind == "decode":
        rec["analytic_traffic"] = analytic_traffic(inp["params"],
                                                   inp["caches"], mode,
                                                   n_chips)
        bytes_est = rec["analytic_traffic"]["bytes_per_device"]
    rec["cost"]["bytes_per_device_est"] = bytes_est
    terms = roof.roofline_terms(
        {c: f / n_chips for c, f in counted.by_class.items()}, bytes_est,
        coll["seconds"], fp8=(mode == "fp8"))
    pcount = roof.count_params(
        steps.param_structs(cfg, serving=False),
        active_expert_fraction=(
            None if cfg.moe is None else
            (cfg.moe.top_k + cfg.moe.n_shared_experts) / cfg.moe.n_experts))
    mf = roof.model_flops(cfg, shape, pcount["active"])
    terms["model_flops_total"] = mf
    terms["useful_ratio"] = mf / max(flops * n_chips, 1.0)
    rec["roofline"] = terms
    rec["params"] = pcount
    return rec


def analytic_traffic(params, caches, mode: str, n_chips: int) -> dict:
    """The decode step's HBM traffic as the JAX record reckons it: every
    param leaf read (an FP8 step reads the upper byte of a nested
    weight only, half its uint8 bytes), every cache plane read (an FP8
    step skips the `_lo` planes) and one token's worth of each plane
    written (its bytes over its capacity axis), over the devices."""
    import torch

    from repro_torch.launch import sharding as SH
    from repro_torch.roofline import analysis as roof
    w_read = 0.0
    for _, leaf, _ in SH.tree_leaves(params):
        b = float(leaf.numel() * leaf.element_size())
        if leaf.dtype == torch.uint8 and mode == "fp8":
            b *= 0.5
        w_read += b
    c_read = c_write = 0.0
    for path, leaf, _ in SH.tree_leaves(caches):
        b = float(leaf.numel() * leaf.element_size())
        if not (mode == "fp8" and "_lo" in "/".join(map(str, path))):
            c_read += b
        cap = leaf.shape[2] if leaf.dim() >= 3 else 1
        c_write += b / max(cap, 1)
    total = (w_read + c_read + c_write) / n_chips
    return {"weights_read_gib": w_read / n_chips / GIB,
            "cache_read_gib": c_read / n_chips / GIB,
            "cache_write_gib": c_write / n_chips / GIB,
            "bytes_per_device": total,
            "memory_s_analytic": total / roof.HBM_BYTES_S}


def run_one(arch_id: str, shape_name: str, mesh_kind: str, mode: str,
            out_dir: str | None = None, kv: str = "f16") -> dict:
    """One cell's record: the JAX record's keys ("status" "skipped" with
    the JAX reason where `steps.shape_supported` refuses the shape)."""
    from repro_torch.configs import INPUT_SHAPES, get_arch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps

    cfg = get_arch(arch_id)
    shape = INPUT_SHAPES[shape_name]
    rec: dict = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
                 "mode": mode, "kv": kv}
    ok, reason = steps.shape_supported(cfg, shape)
    if not ok:
        rec.update({"status": "skipped", "reason": reason})
        return rec
    mesh = mesh_lib.make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rec.update(reckon(cfg, shape, mesh, mode=mode, kv=kv))
    rec["status"] = "ok"
    for key in ("memory", "roofline"):
        print(f"[{key}] {json.dumps(rec[key])}")
    return rec


def _combo_path(out_dir, arch, shape, mesh_kind, mode, kv="f16"):
    suffix = "" if kv == "f16" else f"__{kv}"
    return os.path.join(out_dir,
                        f"{arch}__{shape}__{mesh_kind}__{mode}{suffix}.json")


def _write_one(out_dir, arch, shape, mesh_kind, mode, kv) -> bool:
    """Reckon one cell and write its JSON (an "error" record, with its
    traceback, where the reckoning raised). True when it did not."""
    path = _combo_path(out_dir, arch, shape, mesh_kind, mode, kv)
    try:
        rec = run_one(arch, shape, mesh_kind, mode, out_dir, kv=kv)
        ok = True
    except Exception as e:        # recorded for the report, and counted
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
               "mode": mode, "kv": kv, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        print(rec["error"])
        ok = False
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {path}")
    return ok


def orchestrate(args) -> int:
    """Every requested cell in this process (nothing forces a device
    count), skipping a cell whose JSON exists unless --force."""
    from repro_torch.configs import ASSIGNED, INPUT_SHAPES

    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    failures = []
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                path = _combo_path(out_dir, arch, shape, mk, args.mode,
                                   args.kv)
                if os.path.exists(path) and not args.force:
                    print(f"skip existing {os.path.basename(path)}")
                    continue
                print(f"--- {arch} {shape} {mk} {args.mode}", flush=True)
                if not _write_one(out_dir, arch, shape, mk, args.mode,
                                  args.kv):
                    failures.append((arch, shape, mk))
    print(f"sweep took {time.time() - t0:.1f} s")
    if failures:
        print("failures:", failures)
        return 1
    print("all combos done")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mode", default="fp16", choices=["fp16", "fp8"])
    ap.add_argument("--kv", default="f16", choices=["f16", "planar"])
    ap.add_argument("--out", default=os.path.abspath(ART_DIR))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    if args.all or args.arch == "all" or args.shape == "all" \
            or args.mesh == "both":
        return orchestrate(args)
    os.makedirs(args.out, exist_ok=True)
    return 0 if _write_one(args.out, args.arch, args.shape, args.mesh,
                           args.mode, args.kv) else 1


if __name__ == "__main__":
    sys.exit(main())
