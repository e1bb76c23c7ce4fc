"""Serving on a mesh: ``models.transformer.prefill`` and ``decode_step``
over the virtual shards of a :class:`~repro_torch.launch.mesh.Mesh`, the
decode cache placed as ``launch.shardings.Rules.cache`` places it.

Each shard keeps its slice of every layer's cache (:class:`MeshCache`):

- K/V with enough KV heads split over the model axis by heads; with few,
  the sequence split over the model axis; at a batch the data rows cannot
  split (batch 1), the sequence split over the data axes (and the model
  axis); else the head dim split over the model axis.  The batch is split
  over the data rows where they divide it.  An encoder-decoder's cross K/V
  (the encoder's keys and values, ``"cross"``) by the same rule at the
  encoder's length.
- The recurrent states, ``conv`` and ``h``, split over the model axis by
  their channels or heads, the whole batch on every row.

The serving forward splits the MLP, the experts and the vocabulary over the
model shards as training does (``parallel.ShardedForward``); attention's
projections run whole on every shard (``Layout(split_attention=False)``),
and its work over the cache splits as the cache does: each shard attends
over its slice, a split of the heads or the head dim is gathered exactly,
and a split sequence combines the shards' (max, sum-exp, weighted V) in
shard order.  A new position's K/V is written by the shard that holds its
slot; a "local" layer's ring slots are masked slot by slot.  The model
inputs are ``transformer._inputs``' on each row's part of the batch: a
vision model's patches projected as a prefix that the positions and the
cache count, an encoder-decoder's frames through the frontend and the
encoder's blocks (unmasked, as the mesh trainer runs them).  Each decoder
layer of an encoder-decoder adds its cross-attention to the encoder's
output after its self-attention, in prefill dense and unmasked, in decode
against the shards' slices of the cross K/V as the self K/V (no RoPE, no
mask, no slot written).  A recurrent
layer gathers its state's channels, steps the whole batch (the rows'
inputs gathered where they split it) and keeps its slice.  The logits come
back whole on every shard.  With one shard every op is the one-device
step's.
"""

from __future__ import annotations

import math

import torch

from ..launch.shardings import shard_slices
from . import layers as L
from . import transformer as T
from .collectives import gather_rows
from .parallel import Layout, ShardedForward


def _ordered(ts: list):
    """``ts[0] + ts[1] + ...``, added in that order."""
    acc = ts[0]
    for t in ts[1:]:
        acc = acc + t
    return acc


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class MeshCache:
    """The local shards' slices of a decode cache: ``shards[s]`` one dict
    per layer, as ``transformer.init_cache`` lays a layer out (K/V (B, KV,
    length, Dh), an encoder-decoder's ``"cross"`` K/V (B, KV, S_enc,
    Dh)); ``specs`` per layer, each leaf's spec in that layout (``"cross"``
    a dict of its own); ``lengths`` per layer, its K/V's whole length;
    ``cross_lengths`` per layer, its cross K/V's (0 without one)."""

    def __init__(self, shards: dict, specs: list, lengths: list,
                 cross_lengths: list):
        self.shards, self.specs, self.lengths = shards, specs, lengths
        self.cross_lengths = cross_lengths


class ShardedServer:
    """Prefill and decode of ``cfg`` on ``mesh`` from a
    :class:`~repro_torch.models.parallel.ShardedParams` (its compute views
    gathered once, on the first call with those parameters): decoders, an
    encoder-decoder (its encoder and cross cache) and a vision prefix, as
    the one-device ``transformer.prefill`` and ``decode_step``."""

    def __init__(self, cfg, run, mesh):
        self.cfg, self.run, self.mesh = cfg, run, mesh
        self.layout = Layout(cfg, run, mesh, split_attention=False)
        self.fwd = ShardedForward(self.layout, run)
        self.local = mesh.local_shards
        self._bound, self.trees = None, None

    def bind(self, params):
        if params is not self._bound:
            views = self.layout.views(params, grad=False)
            self.trees = [self.layout.tree(views[s]) for s in self.local]
            self._bound = params

    # -- rows, specs, slices ----------------------------------------------
    def _row_part(self, x, b: int):
        """Each local shard's data row's rows of the full batch ``x``: its
        chunk where the rows divide the batch, else all of it."""
        mesh = self.mesh
        if b % mesh.n_data:
            return [x] * len(self.local), False
        n = b // mesh.n_data
        return [x[d * n:(d + 1) * n] for d in self.fwd.ds], True

    def _kv_spec(self, name: str, b: int, n: int) -> tuple:
        """``Rules.cache_leaf``'s spec of a K/V leaf of ``n`` positions (at
        ``name``, the reference's path), in the port's (B, KV, S, Dh)."""
        cfg = self.cfg
        r = self.layout.rules.cache_leaf(name, (b, n, cfg.n_kv_heads,
                                                cfg.head_dim_))
        return (r[0], r[2], r[1], r[3])

    def _specs(self, kind: str, b: int, cache_len: int, enc_len: int = 0):
        """(a layer's specs in the port's layout, its K/V length); a layer
        with a cross K/V of ``enc_len`` positions also has ``"cross"``."""
        cfg, rules = self.cfg, self.layout.rules
        if kind in ("global", "local"):
            n = min(cache_len, cfg.window) if kind == "local" else cache_len
            spec = self._kv_spec("k", b, n)
            out = {"k": spec, "v": spec}
            if enc_len:
                cross = self._kv_spec("cross/k", b, enc_len)
                out["cross"] = {"k": cross, "v": cross}
            return out, n
        if kind == "rglru":
            h, c = (b, cfg.d_inner), (b, cfg.ssm_conv - 1, cfg.d_inner)
        else:
            h = (b, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
            c = (b, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
        return {"h": rules.cache_leaf("h", h),
                "conv": rules.cache_leaf("conv", c)}, 0

    def _keep(self, full: dict, specs: dict, split: bool) -> list:
        """Each local shard's slices of one layer's cache from its row's
        whole cache (``full``: one dict per local shard); a leaf that every
        row holds for the whole batch is gathered over the rows first."""
        mesh, out = self.mesh, [dict() for _ in self.local]
        for name, spec in specs.items():
            ts = [f[name] for f in full]
            if isinstance(spec, dict):
                for o, sub in zip(out, self._keep(ts, spec, split)):
                    o[name] = sub
                continue
            if split and not _axes(spec[0]):
                ts = gather_rows(mesh, ts, "cache_rows")
            for o, t, s in zip(out, ts, self.local):
                sl = shard_slices((None,) + tuple(spec[1:]), t.shape, mesh, s)
                o[name] = t[sl].contiguous()
        return out

    def place_cache(self, cache: list, cache_len: int) -> MeshCache:
        """A whole decode cache (``transformer.init_cache``'s list, its
        global layers of ``cache_len`` positions, its cross K/V of any
        length) as the local shards' slices, placed as :meth:`prefill`
        places its own."""
        mesh = self.mesh

        def cut(layer, spec, t):
            return {name: cut(layer[name], sp, t) if isinstance(sp, dict)
                    else layer[name][shard_slices(sp, layer[name].shape,
                                                  mesh, t)].contiguous()
                    for name, sp in spec.items()}
        shards = {t: [] for t in self.local}
        specs, lengths, cross = [], [], []
        for kind, layer in zip(self.cfg.layer_kinds(), cache):
            b = next(iter(layer.values())).shape[0]
            n_enc = layer["cross"]["k"].shape[2] if "cross" in layer else 0
            spec, n = self._specs(kind, b, cache_len, n_enc)
            for t in self.local:
                shards[t].append(cut(layer, spec, t))
            specs.append(spec)
            lengths.append(n)
            cross.append(n_enc)
        return MeshCache(shards, specs, lengths, cross)

    # -- the steps --------------------------------------------------------
    def _logits(self, xs: list, split: bool):
        """The last position's logits (B, V_padded) f32, whole."""
        cfg, mesh, dt = self.cfg, self.mesh, self.fwd.dt
        out = []
        for t, x in zip(self.trees, xs):
            xn = L.apply_norm(t["final_norm"], x, cfg)
            w = (t["embed"].T if cfg.tie_embeddings else t["lm_head"]).to(dt)
            out.append((xn @ w).float())
        if self.layout.vocab:
            n = cfg.vocab_padded // mesh.n_model
            out = [torch.where(m * n + torch.arange(n, device=z.device)
                               >= cfg.vocab, -1e30, z)
                   for z, m in zip(out, self.fwd.ms)]
            out = [torch.cat([r[0] for r in row], dim=-1)
                   for row in mesh.gather_model([[z] for z in out], "logits")]
        elif cfg.vocab_padded != cfg.vocab:
            pad = torch.arange(cfg.vocab_padded, device=out[0].device) \
                >= cfg.vocab
            out = [torch.where(pad, -1e30, z) for z in out]
        if split:
            out = [torch.cat([c[0] for c in col]) for col in
                   mesh.gather_data([[z] for z in out], "logits")]
        return out[0]

    @torch.inference_mode()
    def prefill(self, params, batch: dict, cache_len: int = 0):
        """``transformer.prefill`` on the mesh: ``(the last position's
        logits (B, V_padded), the cache as a MeshCache)``.  ``batch`` holds
        the whole batch: ``tokens`` (B, S) and the model's ``frames`` or
        ``patches``; each data row takes its part of every entry (all of it
        where the rows do not divide B).  The cache is sized for
        ``cache_len`` positions, a vision prefix's P included (P + S when
        0)."""
        from ..launch.mesh import data_axes, model_axis
        from .sharding_ctx import mesh_ctx
        self.bind(params)
        cfg, run, fwd = self.cfg, self.run, self.fwd
        b = batch["tokens"].shape[0]
        rows = [dict() for _ in self.local]
        for k, v in batch.items():
            parts, split = self._row_part(v, b)
            for r, part in zip(rows, parts):
                r[k] = part
        fwd.rows_split = split
        shards = {t: [] for t in self.local}
        specs, lengths, cross = [], [], []
        with mesh_ctx(self.mesh, data_axes(self.mesh), model_axis(self.mesh)):
            xs, encs, _ = fwd.inputs(self.trees, rows)
            s = xs[0].shape[1]
            cache_len = cache_len or s
            n_enc = encs[0].shape[1] if encs is not None else 0
            positions = torch.arange(s, device=xs[0].device)[None, :]
            for j, kind in enumerate(cfg.layer_kinds()):
                bps = [t["blocks"][j] for t in self.trees]
                hs = [L.apply_norm(bp["norm1"], x, cfg)
                      for bp, x in zip(bps, xs)]
                if kind == "rglru":
                    got = [T._rglru_with_cache(bp["rglru"], h, cfg, run)
                           for bp, h in zip(bps, hs)]
                elif kind == "ssd":
                    got = [T._ssd_with_cache(bp["ssd"], h, cfg, run)
                           for bp, h in zip(bps, hs)]
                else:
                    got = [T._attn_with_cache(bp["attn"], h, cfg, run, kind,
                                              positions, cache_len)
                           for bp, h in zip(bps, hs)]
                xs = fwd.cross(bps, [x + g[0] for x, g in zip(xs, got)],
                               positions, encs)
                n_cross = n_enc if "cross" in bps[0] else 0
                if n_cross:
                    for (_, c), bp, e in zip(got, bps, encs):
                        c["cross"] = T._cross_kv(bp["cross"], e, cfg, run)
                spec, n = self._specs(kind, b, cache_len, n_cross)
                for t, c in zip(self.local, self._keep([g[1] for g in got],
                                                       spec, split)):
                    shards[t].append(c)
                specs.append(spec)
                lengths.append(n)
                cross.append(n_cross)
                xs = self._feed_forward(bps, xs, kind)
            logits = self._logits([x[:, -1:] for x in xs], split)[:, 0]
        return logits, MeshCache(shards, specs, lengths, cross)

    def _feed_forward(self, bps, xs, kind):
        if kind == "ssd":
            return xs
        cfg, fwd = self.cfg, self.fwd
        h2 = [L.apply_norm(bp["norm2"], x, cfg) for bp, x in zip(bps, xs)]
        ffn = fwd.moe if "router" in bps[0]["ffn"] else fwd.mlp
        return [x + y for x, y in zip(xs, ffn([bp["ffn"] for bp in bps], h2))]

    @torch.inference_mode()
    def decode(self, params, cache: MeshCache, tokens, pos: int):
        """``transformer.decode_step`` on the mesh: ``tokens`` (B, 1), the
        same on every shard, at position ``pos``; ``(logits (B,
        V_padded), cache)``, the cache's slices updated in place."""
        from ..launch.mesh import data_axes, model_axis
        from .sharding_ctx import mesh_ctx
        self.bind(params)
        cfg, fwd = self.cfg, self.fwd
        b = tokens.shape[0]
        rows, split = self._row_part(tokens, b)
        fwd.rows_split = split
        with mesh_ctx(self.mesh, data_axes(self.mesh), model_axis(self.mesh)):
            xs = fwd.embed(self.trees, rows)
            for j, kind in enumerate(cfg.layer_kinds()):
                bps = [t["blocks"][j] for t in self.trees]
                caches = [cache.shards[t][j] for t in self.local]
                hs = [L.apply_norm(bp["norm1"], x, cfg)
                      for bp, x in zip(bps, xs)]
                if kind in ("rglru", "ssd"):
                    outs = self._recur(bps, hs, caches, kind,
                                       cache.specs[j], split)
                else:
                    outs = self._attend([bp["attn"] for bp in bps], hs,
                                        caches, kind, int(pos),
                                        cache.specs[j]["k"],
                                        cache.lengths[j])
                xs = [x + o for x, o in zip(xs, outs)]
                if "cross" in bps[0]:
                    xs = self._cross_attend(bps, xs, caches,
                                            cache.specs[j]["cross"]["k"],
                                            cache.cross_lengths[j])
                xs = self._feed_forward(bps, xs, kind)
            logits = self._logits(xs, split)[:, 0]
        return logits, cache

    def _recur(self, bps, hs, caches, kind, specs, split):
        """One recurrent step: each shard gathers its state's channels (and
        the rows' inputs where they split the batch), steps the whole
        batch, keeps its slice of the new state and its rows' outputs."""
        cfg, run, mesh = self.cfg, self.run, self.mesh
        b_row = hs[0].shape[0]
        if split:
            hs = gather_rows(mesh, hs, "recur_rows")
        whole = [dict() for _ in self.local]
        for name, spec in specs.items():
            dims = [d for d, e in enumerate(spec) if "model" in _axes(e)]
            got = mesh.gather_axes([[c[name]] for c in caches], "state",
                                   ("model",))
            for w, row in zip(whole, got):
                w[name] = torch.cat([r[0] for r in row], dim=dims[0]) \
                    if dims else row[0][0]
        step = L.rglru_decode if kind == "rglru" else L.ssd_decode
        outs = []
        for bp, h, w, c, s, d in zip(bps, hs, whole, caches, self.local,
                                     self.fwd.ds):
            y, w = step(bp[kind], h, w, cfg, run)
            for name, spec in specs.items():
                c[name].copy_(w[name][shard_slices(spec, w[name].shape,
                                                   mesh, s)])
            outs.append(y[d * b_row:(d + 1) * b_row] if split else y)
        return outs

    def _attend(self, ps, hs, caches, kind, pos, spec, length):
        """One token's attention against the shards' slices of a layer's
        K/V (the port's layout, ``spec`` over (B, KV, S, Dh))."""
        cfg, run, mesh = self.cfg, self.run, self.mesh
        dt = L._dtype(run)
        if kind != "local" and not 0 <= pos < length:
            raise IndexError(f"decode position {pos} outside the {length} "
                             f"positions of a global layer's cache")
        if kind == "local" and length < cfg.window and not 0 <= pos < length:
            raise IndexError(f"decode position {pos} outside the {length} "
                             f"slots of a local layer's ring, shorter than "
                             f"its window of {cfg.window}")
        h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        slot = pos % length if kind == "local" else pos
        positions = torch.full((1,), pos, dtype=torch.int64,
                               device=hs[0].device)
        parts = []
        for p, x, c, s in zip(ps, hs, caches, self.local):
            q, k, v = L._qkv(p, x, x, cfg, run)
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
            _, kv_sl, s_sl, d_sl = shard_slices(
                (None,) + tuple(spec[1:]), (1, kvh, length, dh), mesh, s)
            lo = s_sl.start or 0
            if lo <= slot < lo + c["k"].shape[2]:
                c["k"][:, :, slot - lo] = k[:, 0, kv_sl, d_sl]
                c["v"][:, :, slot - lo] = v[:, 0, kv_sl, d_sl]
            b = q.shape[0]
            qh = q.reshape(b, kvh, h // kvh, dh)[:, kv_sl, :, d_sl]
            idx = lo + torch.arange(c["k"].shape[2], device=x.device)
            if kind == "local":
                t = pos - torch.remainder(pos - idx, length)
                valid = (t >= 0) & (t <= pos)
            else:
                valid = idx <= pos
            parts.append((qh, c, valid))
        outs = self._over_cache(parts, spec, dt, "")
        return [o.reshape(o.shape[0], 1, h * dh) @ p["wo"].to(dt)
                for o, p in zip(outs, ps)]

    def _cross_attend(self, bps, xs, caches, spec, length):
        """``xs`` plus each decoder layer's cross-attention of one token
        against the shards' slices of its cross K/V (``spec`` over (B, KV,
        S_enc, Dh)), as ``layers.cross_attention_decode``: no RoPE, no mask,
        no slot written."""
        cfg, run, mesh = self.cfg, self.run, self.mesh
        dt = L._dtype(run)
        h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        parts = []
        for bp, x, c, s in zip(bps, xs, caches, self.local):
            hc = L.apply_norm(bp["cross_norm"], x, cfg)
            q = (hc @ bp["cross"]["wq"].to(dt)).reshape(
                hc.shape[0], kvh, h // kvh, dh)
            _, kv_sl, _, d_sl = shard_slices(
                (None,) + tuple(spec[1:]), (1, kvh, length, dh), mesh, s)
            parts.append((q[:, kv_sl, :, d_sl], c["cross"], None))
        outs = self._over_cache(parts, spec, dt, "cross_")
        return [x + o.reshape(o.shape[0], 1, h * dh) @ bp["cross"]["wo"]
                .to(dt) for x, o, bp in zip(xs, outs, bps)]

    def _over_cache(self, parts, spec, dt, tag: str):
        """Each local shard's attention output (B, KV, G, Dh), whole, from
        its ``(queries (B, KV_s, G, Dh_s), K/V slices, valid slots or
        None)`` over a cache placed by ``spec``: the scores summed over a
        split of the head dim, a split sequence combined (:meth:`_combine`),
        a split of the head dim or the heads gathered; ``tag`` prefixes the
        exchanges' keys."""
        mesh, dh = self.mesh, self.cfg.head_dim_
        kv_ax, s_ax, d_ax = (_axes(e) for e in spec[1:])
        if d_ax:
            part = [qh.float() @ c["k"].float().transpose(-1, -2)
                    for qh, c, _ in parts]
            scores = [_ordered([r[0] for r in row]) / math.sqrt(dh)
                      for row in mesh.gather_axes([[sc] for sc in part],
                                                  tag + "scores", d_ax)]
        else:
            scores = [(qh @ c["k"].transpose(-1, -2)) / math.sqrt(dh)
                      for qh, c, _ in parts]
        scores = [sc.float() if v is None else torch.where(v, sc.float(),
                                                           -1e30)
                  for sc, (_, _, v) in zip(scores, parts)]
        if s_ax:
            outs = self._combine(scores, [c["v"] for _, c, _ in parts], s_ax,
                                 dt, tag)
        else:
            outs = [torch.softmax(sc, dim=-1).to(dt) @ c["v"]
                    for sc, (_, c, _) in zip(scores, parts)]
        if d_ax:
            outs = [torch.cat([r[0] for r in row], dim=-1) for row in
                    mesh.gather_axes([[o] for o in outs], tag + "attn_dh",
                                     d_ax)]
        if kv_ax:
            outs = [torch.cat([r[0] for r in row], dim=1) for row in
                    mesh.gather_axes([[o] for o in outs], tag + "attn_heads",
                                     kv_ax)]
        return outs

    def _combine(self, scores, values, axes, dt, tag: str):
        """Softmax-weighted values over a sequence split over ``axes``:
        each shard's (max, sum-exp, exp-weighted V) in f32, combined in
        shard order."""
        mesh = self.mesh
        stats = []
        for sc, v in zip(scores, values):
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            stats.append([m, p.sum(-1), p @ v.float()])
        out = []
        for row in mesh.gather_axes(stats, tag + "softmax", axes):
            top = row[0][0]
            for r in row[1:]:
                top = torch.maximum(top, r[0])
            ws = [torch.exp(m - top) for m, _, _ in row]
            den = _ordered([l * w for (_, l, _), w in zip(row, ws)])
            num = _ordered([o * w[..., None] for (_, _, o), w in zip(row, ws)])
            out.append((num / den[..., None]).to(dt))
        return out
