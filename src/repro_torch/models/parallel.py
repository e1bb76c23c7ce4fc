"""The port's LMs on a mesh: data, FSDP, tensor and expert parallelism over
the virtual shards of a :class:`~repro_torch.launch.mesh.Mesh`.

The reference shards through GSPMD and never changes a value; so does the
port, up to the order of the cross-shard sums, which the mesh takes in
shard order.  Each shard stores what ``launch.shardings.Rules`` gives it
(:class:`ShardedParams`), and a step runs every local shard's part of the
model in lockstep, layer by layer (:class:`ShardedForward`), meeting the
other shards only through ``models.collectives``:

- **data**: each data row runs its part of the batch;
- **FSDP**: a leaf's data-split dim is gathered before its use
  (:meth:`Layout.views`; exact) and its summed gradient sliced back;
- **model**: the compute splits where ``Rules`` splits whole units:
  attention by query and KV heads (when the model axis divides both), the
  MLP by ``d_ff`` (a gated ``wi`` by the pairs of its two halves), the
  experts by ``E``, the vocabulary (the embedding gather, the logits and a
  vocab-parallel cross-entropy that combines the shards' max and sum-exp
  in shard order).  Every other leaf that ``Rules`` splits is gathered
  whole and computed on every model shard alike: the recurrent layers'
  inner widths, a split inside a head, ``frontend_proj``, the router,
  ``conv``.

Each leaf has a role (:meth:`Layout.role`) that says how its gradient comes
back: ``"split"`` (each model shard's gradient is its own chunk),
``"pair"`` (a gated ``wi``: the chunks are gathered and re-cut to the
stored chunk), ``"replicated"`` (every model shard holds the whole, equal
gradient) or ``"partial"`` (a replicated leaf used inside a split part,
the qk-norm scales: summed over the model shards).  The gradients are then
summed over the data rows in shard order.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..configs.base import ArchConfig, RunConfig
from . import layers as L
from . import transformer as T
from .collectives import (gather_kept, gather_rows, keep, model_copy,
                          model_sum)
from .sharding_ctx import constrain


# ---------------------------------------------------------------------------
# which parts split, and each leaf's place
# ---------------------------------------------------------------------------

def leaf_paths(cfg: ArchConfig) -> list:
    """For each :class:`~repro_torch.models.transformer.Decoder` parameter,
    in ``parameters()`` order: ``(module name, the reference's path, its
    shape, the reference's stacked shape)``; a layer of the block cycle's
    scan is the slice of its stacked leaf."""
    shell = T.Decoder(cfg, None, "meta")
    c, repeats = T._cycle_info(cfg)
    _, enc_repeats = T._cycle_info(cfg, encoder=True)
    out = []
    for name, p in shell.named_parameters():
        parts, shape = name.split("."), tuple(p.shape)
        stacked = shape
        if parts[0] == "blocks":
            i, rest = int(parts[1]), "/".join(parts[2:])
            if i < repeats * c:
                path, stacked = f"blocks/scan/{i % c}/{rest}", (repeats,) + shape
            else:
                path = f"blocks/tail/{i - repeats * c}/{rest}"
        elif parts[:2] == ["encoder", "blocks"]:
            path = f"encoder/scan/0/{'/'.join(parts[3:])}"
            stacked = (enc_repeats,) + shape
        elif parts[:2] == ["encoder", "norm"]:
            path = f"enc_norm/{parts[2]}"
        else:
            path = "/".join(parts)
        out.append((name, path, shape, stacked))
    return out


class Layout:
    """Where each leaf of ``cfg``'s model lives on ``mesh`` under ``run``:
    its spec (``Rules``), the canonical spec that the gradient norm counts
    it by (``Rules`` with FSDP on), its role and the parts that split."""

    def __init__(self, cfg: ArchConfig, run: RunConfig, mesh,
                 split_attention: bool = True):
        from ..launch.shardings import Rules
        self.cfg, self.run, self.mesh = cfg, run, mesh
        self.rules = Rules(cfg, run, mesh)
        canon = Rules(cfg, dataclasses.replace(run, fsdp=True), mesh)
        m = mesh.n_model
        h, kv = cfg.n_heads, cfg.n_kv_heads
        self.attn = split_attention and m > 1 and kv > 0 and h % m == 0 \
            and kv % m == 0
        self.mlp = m > 1 and cfg.d_ff % m == 0
        self.moe = m > 1 and cfg.n_experts > 0 and cfg.n_experts % m == 0
        self.vocab = m > 1 and cfg.vocab_padded % m == 0
        self.cfg_attn = dataclasses.replace(
            cfg, n_heads=h // m, n_kv_heads=kv // m,
            head_dim=cfg.head_dim_) if self.attn else cfg
        self.cfg_mlp = dataclasses.replace(cfg, d_ff=cfg.d_ff // m) \
            if self.mlp else cfg
        self.leaves = leaf_paths(cfg)
        self.names = [n for n, _, _, _ in self.leaves]
        self.shapes = [s for _, _, s, _ in self.leaves]
        self.specs, self.canon, self.roles = [], [], []
        for name, path, shape, stacked in self.leaves:
            lead = len(stacked) - len(shape)
            spec = self.rules.param_spec(path, stacked)[lead:]
            self.specs.append(spec)
            self.canon.append(canon.param_spec(path, stacked)[lead:])
            role = self.role(path, shape)
            if role[0] in ("split", "pair") and spec[role[1]] != "model":
                raise AssertionError(f"{path}: compute split on dim "
                                     f"{role[1]} but stored as {spec}")
            self.roles.append(role)
        # a leaf whose compute view is what each shard stores needs no
        # exchange: no data axis in its spec, and split as stored or whole
        self.local = [not any(_data_axes(e) for e in spec) and
                      (r[0] == "split" or "model" not in spec)
                      for spec, r in zip(self.specs, self.roles)]
        self.model_spec = [tuple(e if e == "model" else None for e in spec)
                           for spec in self.specs]

    def role(self, path: str, shape) -> tuple:
        """``(role, dim)``: how the compute uses the leaf (module docs)."""
        cfg, name = self.cfg, path.rsplit("/", 1)[-1]
        if path == "embed" and self.vocab:
            return ("split", 0)
        if path == "lm_head" and self.vocab:
            return ("split", 1)
        if ("/attn/" in path or "/cross/" in path) and self.attn:
            if name in ("wq", "wk", "wv"):
                return ("split", 1)
            if name == "wo":
                return ("split", 0)
            return ("partial", None)                    # q_scale, k_scale
        if "/ffn/" in path and len(shape) == 3 and self.moe and \
                name in ("wi", "wo"):
            return ("split", 0)
        if "/ffn/" in path and len(shape) == 2 and self.mlp:
            if name == "wo":
                return ("split", 0)
            if name == "wi":
                gated = cfg.act in ("swiglu", "geglu")
                return ("pair", 1) if gated else ("split", 1)
        return ("replicated", None)

    # -- the compute views of a step --------------------------------------
    def _view(self, i: int, full, m: int):
        """Model shard ``m``'s compute view of leaf ``i`` from the whole."""
        role, dim = self.roles[i]
        n = self.mesh.n_model
        if role == "split":
            size = full.shape[dim] // n
            return full.narrow(dim, m * size, size).contiguous()
        if role == "pair":
            return full.index_select(1, _pair_cols(full.shape[1], m, n,
                                                   full.device))
        return full

    def assemble(self, i: int, parts: list):
        """Leaf ``i`` whole from every shard's stored slice (``parts`` in
        shard order); each distinct slice is copied once."""
        from ..launch.shardings import shard_slices
        mesh, shape = self.mesh, self.shapes[i]
        full = torch.empty(shape, dtype=parts[0].dtype, device=parts[0].device)
        done = set()
        for s, t in enumerate(parts):
            sl = shard_slices(self.specs[i], shape, mesh, s)
            key = tuple((x.start, x.stop) for x in sl)
            if key not in done:
                full[sl] = t
                done.add(key)
        return full

    def views(self, params: "ShardedParams", grad: bool = True) -> dict:
        """``{shard: [leaf tensors]}``, each a fresh autograd leaf (with
        ``grad``): the stored slice itself where it is the compute view,
        else the view cut from the leaf gathered whole (one exchange for all
        such leaves).  Local shards of one model column share each view's
        storage."""
        mesh, local = self.mesh, self.mesh.local_shards
        need = [i for i in range(len(self.leaves)) if not self.local[i]]
        got = mesh.gather_all([[params.shards[s][i] for i in need]
                               for s in local], "params") if need else None
        out = {s: [None] * len(self.leaves) for s in local}
        for i in range(len(self.leaves)):
            if self.local[i]:
                for s in local:
                    out[s][i] = params.shards[s][i].detach() \
                        .requires_grad_(grad)
                continue
            j = need.index(i)
            full = self.assemble(i, [g[j] for g in got])
            cut = {}
            for s in local:
                m = mesh.model_index(s)
                if m not in cut:
                    cut[m] = self._view(i, full, m)
                out[s][i] = cut[m].detach().requires_grad_(grad)
            del full
        return out

    def tree(self, leaves: list) -> dict:
        """The leaves as the nested mappings the layer functions read:
        ``embed``, ``final_norm``, ``lm_head``, ``blocks`` (a dict of parts
        per layer), ``encoder`` (``blocks`` and ``norm``),
        ``frontend_proj``."""
        cfg = self.cfg
        cross = cfg.family == "encdec"

        def block(kind, cross_):
            return {p: {} for p in T._PARTS["cross" if cross_ else kind]}
        tree = {"embed": None, "final_norm": {}, "lm_head": None,
                "frontend_proj": None,
                "blocks": [block(k, cross) for k in cfg.layer_kinds()],
                "encoder": {"blocks": [block("global", False)
                                       for _ in range(cfg.n_enc_layers)],
                            "norm": {}} if cross else None}
        for name, t in zip(self.names, leaves):
            parts = name.split(".")
            if parts[0] == "blocks":
                tree["blocks"][int(parts[1])][parts[2]][parts[3]] = t
            elif parts[:2] == ["encoder", "blocks"]:
                tree["encoder"]["blocks"][int(parts[2])][parts[3]][parts[4]] = t
            elif parts[:2] == ["encoder", "norm"]:
                tree["encoder"]["norm"][parts[2]] = t
            elif parts[0] == "final_norm":
                tree["final_norm"][parts[1]] = t
            else:
                tree[parts[0]] = t
        return tree

    # -- gradients back to the stored slices ------------------------------
    def reduce(self, grads: dict):
        """The compute views' gradients ``{shard: [g]}`` as ``({shard: [the
        stored slice's gradient]}, the global norm)``: the model axis
        settles each role, the data rows are summed in shard order, and
        the norm is the 2-norm of every canonical block's norm (each block
        counted by its owner, zeros elsewhere), gathered in shard order."""
        from ..launch.shardings import owns, shard_slices
        mesh, local = self.mesh, self.mesh.local_shards
        n = len(self.leaves)
        # the model axis: sum the partial leaves, gather the pairs
        part = [i for i in range(n) if self.roles[i][0] == "partial"]
        pair = [i for i in range(n) if self.roles[i][0] == "pair"]
        if part:
            summed = mesh.sum_model([[grads[s][i] for i in part]
                                     for s in local], "grads")
            for s, row in zip(local, summed):
                for i, g in zip(part, row):
                    grads[s][i] = g
        if pair:
            rows = mesh.gather_model([[grads[s][i] for i in pair]
                                      for s in local], "grads")
            for s, row in zip(local, rows):
                for j, i in enumerate(pair):
                    full = torch.empty(self.shapes[i], dtype=row[0][j].dtype,
                                       device=row[0][j].device)
                    for m, got in enumerate(row):
                        full[:, _pair_cols(full.shape[1], m, mesh.n_model,
                                           full.device)] = got[j]
                    grads[s][i] = full
        # each leaf's model slice, over the whole data extent
        model = {s: [g if self.roles[i][0] == "split" else
                     g[shard_slices(self.model_spec[i], g.shape, mesh, s)]
                     for i, g in enumerate(grads[s])] for s in local}
        summed = dict(zip(local, mesh.sum_data([model[s] for s in local],
                                               "grads")))
        # the global norm over canonical blocks
        vecs = []
        for s in local:
            own, blocks = [], []
            for i, g in enumerate(summed[s]):
                if owns(self.canon[i], mesh, s):
                    own.append(i)
                    blocks.append(g[shard_slices(_data_only(self.canon[i]),
                                                 g.shape, mesh, s)])
            v = torch.zeros(n, dtype=torch.float32, device=blocks[0].device
                            if blocks else summed[s][0].device)
            if blocks:
                v[own] = torch.stack(torch._foreach_norm(
                    [b.float() for b in blocks]))
            vecs.append([v])
        every = mesh.gather_all(vecs, "gnorm")
        gn = torch.linalg.vector_norm(torch.cat([e[0] for e in every]))
        stored = {s: [g[shard_slices(_data_only(self.specs[i]), g.shape,
                                     mesh, s)]
                      for i, g in enumerate(summed[s])] for s in local}
        return stored, gn


def _pair_cols(cols: int, m: int, n: int, device):
    """Model shard ``m``'s columns of a gated ``wi`` of ``cols`` columns:
    its chunk of each half, so that the activation pairs them."""
    f, size = cols // 2, cols // 2 // n
    idx = torch.arange(m * size, (m + 1) * size, device=device)
    return torch.cat([idx, idx + f])


def _data_axes(entry) -> tuple:
    axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
    return tuple(a for a in axes if a != "model")


def _data_only(spec) -> tuple:
    """The spec with the model axis dropped: the slice of a model chunk
    that a shard's data coordinates give."""
    out = []
    for e in spec:
        axes = _data_axes(e)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


# ---------------------------------------------------------------------------
# parameters as the shards store them
# ---------------------------------------------------------------------------

class ShardedParams:
    """A model's parameters as this rank's shards store them:
    ``shards[s]`` lists shard ``s``'s slices in ``Decoder.parameters()``
    order, each the slice ``Rules`` gives it (:attr:`layout`)."""

    def __init__(self, layout: Layout, shards: dict):
        self.layout, self.shards = layout, shards

    @classmethod
    def from_leaves(cls, layout: Layout, leaves: list):
        """Place whole leaves (tensors in ``parameters()`` order)."""
        from ..launch.shardings import place
        shards = {s: [] for s in layout.mesh.local_shards}
        for t, spec in zip(leaves, layout.specs):
            for s, piece in place(t.detach(), spec, layout.mesh).items():
                shards[s].append(piece)
        return cls(layout, shards)

    @classmethod
    def from_module(cls, layout: Layout, module):
        return cls.from_leaves(layout, list(module.parameters()))


def gather_leaves(layout: Layout, shards: dict, device=None) -> list:
    """Whole leaves from every shard's slices (``{shard: [tensors]}`` as
    :class:`ShardedParams` holds them, or AdamW's moments), on ``device``
    (their own when None): one exchange, then each leaf assembled."""
    mesh = layout.mesh
    got = mesh.gather_all([shards[s] for s in mesh.local_shards], "gather")
    out = []
    for i in range(len(layout.leaves)):
        full = layout.assemble(i, [g[i] for g in got])
        out.append(full if device is None else full.to(device))
    return out


# ---------------------------------------------------------------------------
# the forward, every local shard in lockstep
# ---------------------------------------------------------------------------

class ShardedForward:
    """The training forward of :mod:`models.transformer`, op for op, over
    the local shards' compute views (a list of :meth:`Layout.tree` trees,
    in ``mesh.local_shards`` order)."""

    def __init__(self, layout: Layout, run: RunConfig):
        self.layout, self.run, self.cfg = layout, run, layout.cfg
        self.mesh = layout.mesh
        self.ms = [self.mesh.model_index(s) for s in self.mesh.local_shards]
        self.ds = [self.mesh.data_index(s) for s in self.mesh.local_shards]
        self.dt = L._dtype(run)
        self.rows_split = False         # each data row holds its own rows

    # -- embedding, frontend, head ----------------------------------------
    def embed(self, trees, tokens: list) -> list:
        cfg, lay, dt = self.cfg, self.layout, self.dt
        if not lay.vocab:
            return [t["embed"][tok].to(dt) * math.sqrt(cfg.d_model)
                    for t, tok in zip(trees, tokens)]
        n = cfg.vocab_padded // self.mesh.n_model
        rows = []
        for t, tok, m in zip(trees, tokens, self.ms):
            ids = tok - m * n
            inside = (ids >= 0) & (ids < n)
            rows.append(torch.where(inside[..., None],
                                    t["embed"][ids.clamp(0, n - 1)], 0.0))
        rows = model_sum(self.mesh, rows, "embed")
        return [r.to(dt) * math.sqrt(cfg.d_model) for r in rows]

    def frontend(self, trees, embs: list) -> list:
        return [e.to(self.dt) @ t["frontend_proj"].to(self.dt)
                for t, e in zip(trees, embs)]

    def loss_parts(self, trees, xs: list, labels: list, own: list) -> list:
        """Per local shard ``(sum of the token CEs, count)`` over the valid
        labels of its own positions (``own`` a mask, or None for all):
        ``_ce_loss``'s numerator and denominator."""
        cfg, lay, dt, mesh = self.cfg, self.layout, self.dt, self.mesh
        xn = [L.apply_norm(t["final_norm"], x, cfg) for t, x in zip(trees, xs)]
        ws = [(t["embed"].T if cfg.tie_embeddings else t["lm_head"]).to(dt)
              for t in trees]
        valid = [lab >= 0 if o is None else (lab >= 0) & o
                 for lab, o in zip(labels, own)]
        labs = [lab.clamp_min(0).long() for lab in labels]
        if not lay.vocab:
            out = []
            for h, w, v, lab in zip(xn, ws, valid, labs):
                logits = (h @ w).float()
                if cfg.vocab_padded != cfg.vocab:
                    pad = torch.arange(cfg.vocab_padded,
                                       device=h.device) >= cfg.vocab
                    logits = torch.where(pad, -1e30, logits)
                logz = torch.logsumexp(logits, dim=-1)
                ll = torch.gather(logits, -1, lab[..., None])[..., 0]
                out.append((((logz - ll) * v).sum(), v.sum()))
            return out
        n = cfg.vocab_padded // mesh.n_model
        xn = model_copy(mesh, xn, "head")
        logits = []
        for h, w, m in zip(xn, ws, self.ms):
            z = (h @ w).float()
            pad = m * n + torch.arange(n, device=h.device) >= cfg.vocab
            logits.append(torch.where(pad, -1e30, z))
        # the row's max, exact in any order; then the ordered sum-exp
        peaks = mesh.gather_model([[z.detach().amax(-1)] for z in logits],
                                  "ce_max")
        gmax = [functools.reduce(torch.maximum, [p[0] for p in row])
                for row in peaks]
        sumexp = model_sum(mesh, [torch.exp(z - g[..., None]).sum(-1)
                                  for z, g in zip(logits, gmax)], "ce_sum")
        picked = []
        for z, lab, m in zip(logits, labs, self.ms):
            loc = lab - m * n
            inside = (loc >= 0) & (loc < n)
            got = torch.gather(z, -1, loc.clamp(0, n - 1)[..., None])[..., 0]
            picked.append(torch.where(inside, got, 0.0))
        picked = model_sum(mesh, picked, "ce_label")
        return [(((g + torch.log(se) - ll) * v).sum(), v.sum())
                for g, se, ll, v in zip(gmax, sumexp, picked, valid)]

    # -- blocks -----------------------------------------------------------
    def attention(self, ps, hs, kind, positions, causal, enc=None):
        lay, run, mesh = self.layout, self.run, self.mesh
        encs = [None] * len(hs) if enc is None else enc
        if not lay.attn:
            return [L.attention_train(p, h, self.cfg, run, kind=kind,
                                      positions=positions, causal=causal,
                                      enc=e) for p, h, e in zip(ps, hs, encs)]
        hs = model_copy(mesh, hs, "attn_in")
        if enc is not None:
            encs = model_copy(mesh, encs, "cross_in")
        outs = [L.attention_train(p, h, lay.cfg_attn, run, kind=kind,
                                  positions=positions, causal=causal, enc=e)
                for p, h, e in zip(ps, hs, encs)]
        return model_sum(mesh, outs, "attn_out")

    def mlp(self, ps, hs):
        lay, mesh = self.layout, self.mesh
        if not lay.mlp:
            return [L.mlp(p, h, self.cfg, self.run) for p, h in zip(ps, hs)]
        hs = model_copy(mesh, hs, "mlp_in")
        return model_sum(mesh, [L.mlp(p, h, lay.cfg_mlp, self.run)
                                for p, h in zip(ps, hs)], "mlp_out")

    def moe(self, ps, hs):
        """``layers.moe_mlp`` with the experts split over the model shards:
        every shard routes every token (the router is whole), computes its
        own experts' slots and combines them in slot order; the row's
        partial outputs are summed in shard order.  By default each shard
        dispatches every slot and keeps its experts' (``keep``); with
        ``run.moe_ep_local`` the index maps are constrained to its experts
        first, so that it gathers only their slots, as the reference pins
        its dispatch.  Either way the dispatch's gradient is the whole
        ordered sum over each token's slots.

        Where the data rows split the batch, the tokens compete for the
        experts' capacity over the whole batch, as on one device: each row
        gathers every row's tokens (``gather_rows``), routes them all, and
        masks the slots of other rows' tokens (no token, weight 0), so that
        it computes and combines its own tokens' slots and keeps their
        outputs."""
        cfg, run, mesh, dt = self.cfg, self.run, self.mesh, self.dt
        rows = self.rows_split and mesh.n_data > 1
        if rows:
            b_row = hs[0].shape[0]
            hs = gather_rows(mesh, hs, "moe_rows")
        if not self.layout.moe and not rows:
            return [L.moe_mlp(p, h, cfg, run) for p, h in zip(ps, hs)]
        b, s, d = hs[0].shape
        n = b * s
        e, k, nm = cfg.n_experts, cfg.experts_per_tok, mesh.n_model
        g = run.moe_groups if run.moe_groups and n % run.moe_groups == 0 \
            else 1
        cap = max(1, int(math.ceil(n // g * k / e * run.moe_capacity)))
        el = e // nm
        xts = constrain([h.reshape(g, n // g, d) for h in hs],
                        ("dp", None, None))
        routed = [[torch.stack(t) for t in zip(*[
            L._moe_route(xt[i], p["router"], k, cap, dt) for i in range(g)])]
            for xt, p in zip(xts, ps)]
        takes, w_slots, invs = (list(t) for t in zip(*routed))
        if rows:
            ng = n // g
            start = torch.arange(g, device=hs[0].device)[:, None, None] * ng
            for j, di in enumerate(self.ds):
                lo, hi = di * b_row * s, (di + 1) * b_row * s
                own = (takes[j] < ng) & (start + takes[j] >= lo) & \
                    (start + takes[j] < hi)
                takes[j] = torch.where(own, takes[j], ng)
                w_slots[j] = torch.where(own, w_slots[j], 0.0)
        if not self.layout.moe:
            outs = [_moe_experts(p, xt, tk, w, iv, cfg, dt)
                    for p, xt, tk, w, iv in zip(ps, xts, takes, w_slots, invs)]
            return _own_rows(outs, b, s, d, b_row, self.ds)
        if run.moe_ep_local:
            own_take = constrain(takes, ("dp", "tp", None))
            own_w = constrain(w_slots, ("dp", "tp", None))
            hb = _dispatch_own(mesh, xts, own_take, takes, invs)
        else:
            hb = keep(mesh, [L._Dispatch.apply(xt, tk, iv) for xt, tk, iv in
                             zip(xts, takes, invs)], 1, "moe_dispatch")
            own_take = keep(mesh, takes, 1)
            own_w = keep(mesh, w_slots, 1, "moe_weights")
        outs = []
        for p, hbm, tk, w, iv, m in zip(ps, hb, own_take, own_w, invs,
                                        self.ms):
            h = L._act(torch.einsum("gecd,edf->gecf", hbm, p["wi"].to(dt)),
                       cfg)
            yb = torch.einsum("gecf,efd->gecd", h, p["wo"].to(dt))
            contrib = yb * w[..., None].to(dt)
            outs.append(L._Combine.apply(contrib, tk,
                                         _own_slots(iv, m, el, cap)))
        if rows:
            return model_sum(mesh, _own_rows(outs, b, s, d, b_row, self.ds),
                             "moe_out")
        outs = model_sum(mesh, outs, "moe_out")
        return [o.reshape(b, s, d) for o in outs]

    def block(self, bps, xs, kind, positions, enc, causal):
        """``transformer.Block.forward`` over the local shards."""
        cfg, run = self.cfg, self.run
        hs = [L.apply_norm(bp["norm1"], x, cfg) for bp, x in zip(bps, xs)]
        if kind == "rglru":
            outs = [L.rglru_train(bp["rglru"], h, cfg, run)
                    for bp, h in zip(bps, hs)]
        elif kind == "ssd":
            outs = [L.ssd_train(bp["ssd"], h, cfg, run)
                    for bp, h in zip(bps, hs)]
        else:
            outs = self.attention([bp["attn"] for bp in bps], hs, kind,
                                  positions, causal)
        xs = self.cross(bps, [x + o for x, o in zip(xs, outs)], positions,
                        enc)
        if kind == "ssd":
            return xs
        h2 = [L.apply_norm(bp["norm2"], x, cfg) for bp, x in zip(bps, xs)]
        ffn = self.moe if "router" in bps[0]["ffn"] else self.mlp
        return [x + y for x, y in zip(xs, ffn([bp["ffn"] for bp in bps], h2))]

    def cross(self, bps, xs, positions, enc):
        """``transformer.Block.cross_step`` over the local shards: ``xs``
        plus the cross-attention of their norm to ``enc`` (one encoder
        output per local shard); ``xs`` itself for a block without it."""
        if "cross" not in bps[0]:
            return xs
        if enc is None:
            raise ValueError("a decoder layer with cross-attention needs "
                             "the encoder's output")
        hc = [L.apply_norm(bp["cross_norm"], x, self.cfg)
              for bp, x in zip(bps, xs)]
        cs = self.attention([bp["cross"] for bp in bps], hc, "global",
                            positions, True, enc)
        return [x + c for x, c in zip(xs, cs)]

    def stack(self, blocks: list, xs, positions, cycle, kinds, enc=None,
              causal=True):
        """``transformer._apply_blocks`` over the local shards: each repeat
        of the block cycle one body under ``run.remat``, then the tail.
        With ``run.act_shard == "seq"`` each model shard keeps its chunk of
        the sequence after every block of a body (``constrain``), gathered
        exactly at the next block."""
        mesh, run = self.mesh, self.run
        c, repeats = cycle
        cut = run.act_shard == "seq" and mesh.n_model > 1 and \
            xs[0].shape[1] % mesh.n_model == 0

        def one(j, xs, kept):
            if kept:
                xs = gather_kept(mesh, xs, 1, "seq")
            return self.block([b[j] for b in blocks], xs, kinds[j],
                              positions, enc, causal)

        def body(r, kept, *xs):
            xs = list(xs)
            for j in range(r * c, (r + 1) * c):
                xs = one(j, xs, kept)
                kept = cut
                if cut:
                    xs = constrain(xs, ("dp", "tp", None))
            return tuple(xs)
        body = T._remat(body, run)
        kept = False
        for r in range(repeats):
            xs = list(body(r, kept, *xs))
            kept = cut
        for j in range(repeats * c, len(kinds)):
            xs = one(j, xs, kept)
            kept = False
        return gather_kept(mesh, xs, 1, "seq") if kept else xs

    def inputs(self, trees, batch: list):
        """``transformer._inputs`` over the local shards (``batch`` one dict
        per local shard): ``(xs, enc, offset)``, the embedded tokens after
        the projected patch prefix, the encoder's output (a list, or
        ``None``) and the prefix's length.  A missing modality entry raises
        ``ValueError``."""
        cfg = self.cfg
        missing = [k for k in T.modality_inputs(cfg)
                   if batch[0].get(k) is None]
        if missing:
            raise ValueError(f"{cfg.name} reads batch entries {missing} "
                             f"besides the tokens")
        xs = self.embed(trees, [b["tokens"] for b in batch])
        enc, offset = None, 0
        if cfg.family == "encdec":
            e = self.frontend(trees, [b["frames"] for b in batch])
            pos_e = torch.arange(e[0].shape[1], device=e[0].device)[None, :]
            e = self.stack([t["encoder"]["blocks"] for t in trees], e, pos_e,
                           T._cycle_info(cfg, encoder=True),
                           ("global",) * cfg.n_enc_layers, causal=False)
            enc = [L.apply_norm(t["encoder"]["norm"], x, cfg)
                   for t, x in zip(trees, e)]
        elif cfg.frontend == "vision":
            pre = self.frontend(trees, [b["patches"] for b in batch])
            xs = [torch.cat([p, x], dim=1) for p, x in zip(pre, xs)]
            offset = pre[0].shape[1]
        return xs, enc, offset

    def __call__(self, trees, batch: list, own: list) -> list:
        """Per local shard ``(loss sum, count)`` of its row's batch
        (``transformer.train_loss`` split at the mean's division)."""
        cfg = self.cfg
        xs, enc, offset = self.inputs(trees, batch)
        positions = torch.arange(xs[0].shape[1], device=xs[0].device)[None, :]
        xs = self.stack([t["blocks"] for t in trees], xs, positions,
                        T._cycle_info(cfg), cfg.layer_kinds(), enc)
        return self.loss_parts(trees, [x[:, offset:] for x in xs],
                               [b["labels"] for b in batch], own)


def _moe_experts(p, xt, take, w_slot, inv, cfg, dt):
    """``layers.moe_mlp`` after its routing: dispatch, the experts and the
    combine, (G, n, d)."""
    hb = L._Dispatch.apply(xt, take, inv)
    h = L._act(torch.einsum("gecd,edf->gecf", hb, p["wi"].to(dt)), cfg)
    yb = torch.einsum("gecf,efd->gecd", h, p["wo"].to(dt))
    return L._Combine.apply(yb * w_slot[..., None].to(dt), take, inv)


def _own_rows(outs, b, s, d, b_row, ds):
    """Each shard's own data row's rows of the whole batch's output."""
    return [o.reshape(b, s, d)[di * b_row:(di + 1) * b_row]
            for o, di in zip(outs, ds)]


def _own_slots(inv, m: int, el: int, cap: int):
    """A token's slots (``inv``, into all ``E * cap``) as indices into model
    shard ``m``'s ``el * cap`` slots; another shard's slot, or a dropped
    one, reads the zero row."""
    lo, hi = m * el * cap, (m + 1) * el * cap
    return torch.where((inv >= lo) & (inv < hi), inv - lo, el * cap)


class _DispatchOwn(torch.autograd.Function):
    """Each local shard's own experts' slots ``xt[take_own]`` forward; the
    gradient of every slot gathered over the row's model shards backward and
    summed over each token's slots in slot order, as the whole dispatch's
    backward sums them."""

    @staticmethod
    def forward(ctx, mesh, n, *args):
        xts, owns, invs = args[:n], args[n:2 * n], args[2 * n:]
        ctx.mesh, ctx.n = mesh, n
        ctx.save_for_backward(*invs)
        out = []
        for xt, tk in zip(xts, owns):
            g, _, d = xt.shape
            pad = torch.cat([xt, xt.new_zeros(g, 1, d)], dim=1)
            gidx = torch.arange(g, device=xt.device)[:, None, None]
            out.append(pad[gidx, tk])
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        invs = ctx.saved_tensors
        rows = ctx.mesh.gather_model([[g.contiguous()] for g in gs],
                                     "moe_dispatch")
        out = []
        for row, inv in zip(rows, invs):
            full = torch.cat([r[0] for r in row], dim=1)   # (G, E, C, d)
            g_, e, c, d = full.shape
            out.append(L._ordered_sum(full.reshape(g_, e * c, d), inv))
        return (None, None) + tuple(out) + (None,) * (2 * ctx.n)


def _dispatch_own(mesh, xts, owns, takes, invs):
    if mesh.n_model == 1:
        return [L._Dispatch.apply(xt, tk, iv)
                for xt, tk, iv in zip(xts, takes, invs)]
    return list(_DispatchOwn.apply(mesh, len(xts), *xts, *owns, *invs))
