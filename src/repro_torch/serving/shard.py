"""Tensor-parallel placement for the paged serving engine.

The port of the JAX package's `serving/shard.py`. One engine drives a
("model",) mesh (`launch.mesh.Mesh`) as ONE logical device: weights and
the paged pool are cut into one piece a shard at construction, and every
step is one call of `sharded_paged_step`, which runs each layer shard by
shard and reduces where the layout says (`Mesh.all_reduce`). The host
scheduler (BlockManager, chunk planner, controller) is untouched: it
never knew about devices.

Layout (`launch.sharding`):

  NestedFP weights   `param_spec`: attention head-parallel (q, k, v by
                     columns, wo by rows), the row-parallel fallback
                     where the head count does not divide, gemma3's K/V
                     kept whole where the kv heads do not divide; MLA's
                     wq_b / wk_b / wv_b by heads, wq_a by columns, wkv_a
                     whole; the MLP's gate and up by columns and down by
                     rows; MoE banks by experts (expert-parallel) or,
                     where the padded expert count does not divide, by
                     F (per-expert tensor parallel), the router whole;
                     Mamba2's in_z / in_x / conv_x by heads' channels,
                     out_proj by rows, in_bc / in_dt / the BC conv and
                     the per-head scalars whole; the embedding and the
                     LM head by vocab.
  paged KV pool      `paged_cache_spec`: GQA planes (a hybrid's shared
                     attention's too) split by kv heads, or whole on
                     every shard (its own copy); MLA latents whole.
  slot-resident state  the SSM state by heads, conv_x by channels,
                     conv_bc whole; `kvcache.SlotManager` stays one
                     host-side scheduler.
  block tables       replicated: the BlockManager keeps one device table
                     a device, all flushed by one logical flush a step.
  step operands      replicated (tokens, rows, slot, q_offset, kv_len,
                     logit_position): `put_replicated`.

Every decoder-only family is served: dense (GQA + SwiGLU), moe (with
MLA), ssm and hybrid. encdec raises NotImplementedError
(`check_family`), as the engine refuses it unsharded.
"""

from __future__ import annotations

import torch

from repro_torch.core import nestedfp as nf
from repro_torch.core.linear import NestedLinearParams
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M

def check_family(cfg) -> None:
    """Raise unless a mesh can serve `cfg`: encdec's refusal from
    `model.cache_descriptor` (the paged engine serves decoder-only
    stacks)."""
    M.cache_descriptor(cfg)


def replicated(mesh: Mesh) -> tuple[torch.device, ...]:
    """The placement 'every shard holds all of it': the shards' devices,
    one entry a shard."""
    return mesh.devices


def put_replicated(mesh: Mesh, a) -> list[torch.Tensor]:
    """A host array or tensor placed whole on every shard: one copy a
    device, shared by the shards on it."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
    return mesh.replicate(t.to(mesh.devices[0]))


def _own(t: torch.Tensor, device) -> torch.Tensor:
    """A copy of `t` in memory of its own on `device` (a shard's slice
    frees with its engine)."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def _piece(t: torch.Tensor | None, spec, mesh: Mesh, s: int):
    """Shard s's piece of a leaf: its slice in memory of its own, or, for
    a leaf kept whole, the leaf itself on the shard's device (shared by
    shards on that device, and with the unsharded tree there)."""
    if t is None:
        return None
    dev = mesh.devices[s]
    cut = SH.shard_bounds(spec, t.shape, mesh, s)
    if cut is None:
        return t.to(dev)
    d, start, n = cut
    return _own(t.narrow(d, start, n), dev)


def _nested_piece(w: nf.NestedTensor, spec, mesh: Mesh, s: int):
    """Shard s's piece of a nested weight: its byte planes (or, for an
    exception tensor, its raw f16) sliced as stored. Never re-encoded:
    whether the tensor is an exception is the whole tensor's, so a slice
    with no |w| > 1.75 of an exception tensor still runs K3 (re-running
    `from_f16` on it would send it to K2)."""
    return nf.NestedTensor(*(_piece(t, spec, mesh, s)
                             for t in (w.upper, w.lower, w.raw)))


def _shard_tree(node, path: tuple, cfg, mesh: Mesh, s: int):
    if isinstance(node, NestedLinearParams):
        spec = SH.param_spec(path + ("w",), node.weight.shape, cfg, mesh)
        # the bias follows its weight's output columns (the JAX package
        # places some biases whole and lets GSPMD cut the add)
        bspec = (spec[-1],)
        return NestedLinearParams(_nested_piece(node.weight, spec, mesh, s),
                                  _piece(node.bias, bspec, mesh, s))
    if isinstance(node, nf.NestedTensor):
        return _nested_piece(node, SH.param_spec(path, node.shape, cfg, mesh),
                             mesh, s)
    if isinstance(node, dict):
        return {k: _shard_tree(v, path + (k,), cfg, mesh, s)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_shard_tree(v, path + (i,), cfg, mesh, s)
                          for i, v in enumerate(node))
    if isinstance(node, torch.Tensor):
        return _piece(node, SH.param_spec(path, node.shape, cfg, mesh),
                      mesh, s)
    return node


def shard_subtree(node, path: tuple, cfg, mesh: Mesh) -> list:
    """One piece a shard of the serving subtree at `path` (e.g. ("layers",
    0, "moe")): every leaf cut as `sharding.param_spec` says of it."""
    return [_shard_tree(node, path, cfg, mesh, s) for s in range(mesh.size)]


def shard_serving_params(params, cfg, mesh: Mesh) -> list:
    """One serving tree a shard, from a port serving tree (`to_serving`,
    `init_serving_params`, `from_jax_serving`): every leaf cut as
    `sharding.param_spec` says, a nested weight's byte planes (or an
    exception tensor's raw f16) sliced as stored."""
    check_family(cfg)
    return shard_subtree(params, (), cfg, mesh)


def sharded_paged_step(mesh: Mesh, rt, params: list, cfg, tokens, caches: list,
                       block_tables, *, q_offset, kv_len, block_size: int,
                       logit_position=None, rows=None, slot=None,
                       return_logits: bool = False, sample_all: bool = False):
    """`model.paged_step` on a mesh: the same arguments after the leading
    mesh, with `params` and `caches` one entry a shard
    (`shard_serving_params`, `model.init_paged_cache(mesh=)`) and
    `block_tables` one tensor, or one a shard (the BlockManager's copy on
    each shard's device). The small operands are placed whole on every
    shard's device; each device computes the pool indices once for its
    shards. The stack follows the family, as `model.paged_step` does:
    GQA and MLA stacks `model.run_decoder_stack_mesh`, recurrent ones
    (their `slot` routing a one-row chunk) `model.run_ssm_stack_mesh`.
    Returns the sampled ids (or logits) on the first shard's device, the
    same on every shard, so the engine's end-of-step sync stays one host
    read of one array. Adds no host sync."""
    check_family(cfg)
    lay = SH.serving_layout(cfg, mesh)
    tables = list(block_tables) if isinstance(block_tables, (list, tuple)) \
        else mesh.replicate(block_tables)

    def pin(x):
        return None if x is None else put_replicated(mesh, x)
    toks, qo, kl, lp, rw, sl = map(pin, (
        tokens, q_offset, kv_len, logit_position, rows,
        None if slot is None else slot.to(torch.int64)))
    per_dev: dict = {}
    idx = []
    for s, dev in enumerate(mesh.devices):
        if dev not in per_dev:
            per_dev[dev] = M.paged_indices(
                cfg, toks[s], tables[s], q_offset=qo[s], kv_len=kl[s],
                block_size=block_size, rows=None if rw is None else rw[s])
        idx.append(per_dev[dev])
    hs = M.embed_tokens_mesh(rt, mesh, lay, params, cfg, toks)
    if idx[0].desc.slot_planes:
        hs = M.run_ssm_stack_mesh(rt, mesh, lay, params, cfg, hs,
                                  caches=caches, idx=idx, slot=sl)
    else:
        hs = M.run_decoder_stack_mesh(rt, mesh, lay, params, cfg, hs,
                                      caches=caches, idx=idx)
    if not sample_all:
        hs = [M.logit_rows(h, None if lp is None else lp[s])
              for s, h in enumerate(hs)]
    # each shard's logits of its vocab slice where the head is split
    # (lay.vocab; a tied head is the embedding's rows), else all of them
    logits = [M.lm_logits(rt, p, cfg, h) for p, h in zip(params, hs)]
    if not sample_all:
        logits = [x[:, 0] for x in logits]
    if not lay.vocab:
        logits = logits[:1]          # whole on every shard: the first's
    if return_logits:
        return torch.cat([x.to(mesh.devices[0]) for x in logits], dim=-1)
    if len(logits) == 1:
        return torch.argmax(logits[0], dim=-1).to(torch.int32)
    return M.sharded_argmax(mesh, logits)
