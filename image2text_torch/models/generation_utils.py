"""Batched stochastic beam search (counterpart of
``image2text_tpu/models/generation_utils.py::BeamSearchTokenGenerator``).

The encoder runs once and its output is tiled ``beam_width`` times, beam
major (row ``beam · bs + sample``).  Each round every beam proposes
``beam_expansion_factor`` candidates (``sampling.beam_candidates_with_ngram``:
n-gram bans, top-k, the best ones when ``temperature <= 0``, otherwise
drawn without replacement by Gumbel-top-k; the dense fallback where that
scorer declines).  Sticky EOS: a beam whose last token is EOS keeps
emitting EOS at zero added score whenever its candidate scores below
``-log(length_boost)``; every other candidate gains ``log(length_boost)``.
Consolidation keeps ``beam_width`` of the bw·bef candidates per sample by
top-k or by Gumbel sampling at ``consolidation_temperature``, then gathers
the id buffer, the scores and the KV cache along the beam axis.  The
rounds run while ``cur_len < max_new_tokens + prompt_len - 1`` and some
beam holds no EOS among its first ``cur_len`` ids (JAX's ``not_done``);
the unwritten tail is filled with EOS.  Returns ids (bs, bw, T) and
cumulative log-scores (bs, bw).

Two routes run those rounds, chosen by ``models/graphs.py::graph_plan``
(``graphs=False`` keeps the eager one):

* the **graph route** (the card, a one-device decoder on the cached
  branch) replays one captured CUDA graph of :meth:`cached_rounds`, the
  counterpart of JAX's jitted ``lax.while_loop``: every round of the
  window runs, the done flag is evaluated on the device at the start of
  each, and a round entered with it set leaves the ids and scores as they
  were; the rounds taken are counted on the device and the EOS fill is a
  mask past them.  Nothing is read back to the host.
* the **eager route** runs the same rounds in a Python loop that reads the
  flag once a round and stops at it (JAX's early exit); it also serves the
  fallback and the mesh.

Both give the same ids and scores bit for bit.  The graph draws the
noise of every round of the window; so that a run of calls on one
generator draws alike on both routes, the eager route, after an early
exit, draws and drops the noise of each round it skipped
(:meth:`_skip_draws`: the same calls with the same shapes, so any
generator, the CPU's too, ends in the same state).  After a call
``rounds`` holds the decode rounds the route ran (the whole window on the
graph route) and ``rounds_taken`` the rounds taken before every beam was
done, a device tensor on both routes (a replay leaves it unread).

Decoding is the cached branch of ``models/generation.py`` for both decoder
kinds: the scratch decoder at offset ``space_for_prompt``, and the
``prefix_in_decode`` decoders (the HF families) with the soft prompt in
the cache; ``cross_kv_quant='int8'`` decodes against the int8
cross-attention memory (the prefill reads the exact one).  Where the
cache cannot serve the window (a sparse layer's selected count crosses 2
inside it, or a decoder without ``supports_kv_cache``) every round
re-forwards the whole id buffer under ``sparse_rule_len`` and reads the
logits at ``cur_len - 1`` (JAX ``_full_logits``).  A bidirectional
decoder raises ``ValueError``, as in JAX.  Logits reach the scorer in
f32, as in the JAX generator.  :meth:`BeamSearchTokenGenerator.caption`
is the serving path from raw uint8 frames.

Under a model split (``parallel/sharding_rules.py::place_params``)
every rank of the model group searches the same rows, on the eager
route: each rank's KV cache holds its own heads and is gathered along
the beam axis by the same order.  The ranks must choose the same beams,
or their caches part: the logits are the same on every rank (the row
splits' sums are all-reduced), the stochastic noise is drawn from one
seed on every rank (a generator the caller gives, or one seeded from the
group's first rank), and every round the chosen beams and ids are
all-gathered over the group and compared (``agreed`` counts the rounds
checked), so a tie broken differently on two ranks raises instead of
splitting the caches.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from image2text_torch.models.generation import (decoder_step, prefill,
                                                precompute_cross_kv,
                                                preprocess_frames,
                                                quantize_cross_kv)
from image2text_torch.models.sampling import (apply_no_repeat_ngram,
                                              apply_top_k,
                                              beam_candidates_with_ngram,
                                              gumbel_noise,
                                              gumbel_topk_sample, topk)
from image2text_torch.nn.modules import model_axis


def group_generator(axis, device) -> torch.Generator:
    """A generator seeded alike on every rank of ``axis``'s group: the
    seed is drawn on the group's first rank and broadcast."""
    seed = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64).to(device)
    dist.broadcast(seed, src=dist.get_global_rank(axis.group, 0),
                   group=axis.group)
    return torch.Generator(device=device).manual_seed(int(seed.item()))


def beams_agree(axis, *tensors: torch.Tensor) -> None:
    """Raise unless every rank of ``axis``'s group holds the same integer
    ``tensors`` (one all-gather)."""
    t = torch.cat([x.reshape(-1).to(torch.int64) for x in tensors])
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    for r, p in enumerate(parts[1:], 1):
        if not torch.equal(p, parts[0]):
            raise RuntimeError(f"beam search: model rank {r} chose other "
                               "beams than rank 0; the KV caches would part")


class BeamSearchTokenGenerator:
    def __init__(self, model, beam_width: int = 3, temperature: float = 1.0,
                 top_k: Optional[int] = None, max_new_tokens: int = 64,
                 no_repeat_n_grams: Sequence[int] = (2, 3, 4),
                 beam_expansion_factor: int = 4,
                 eos_token_id: Optional[int] = None,
                 consolidation_temperature: float = 1.0,
                 length_boost: float = 1.0,
                 cross_kv_quant: Optional[str] = None):
        self.model = model
        self.cross_kv_quant = cross_kv_quant
        self.beam_width = beam_width
        self.beam_expansion_factor = beam_expansion_factor
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.consolidation_temperature = consolidation_temperature
        self.top_k = top_k
        self.eos_token_id = eos_token_id
        self.boost = length_boost
        self.length_boost = math.log(length_boost)
        self.no_repeat_n_grams = tuple(no_repeat_n_grams)
        self.rounds = 0     # decode rounds the last call ran
        self.rounds_taken = None    # of them, taken before all were done
        self.agreed = 0     # of them, checked alike over the model group

    def settings(self) -> dict:
        """The constructor's keywords past the model: what a call computes
        from, and a captured call's key (``models/graphs.py``)."""
        return dict(beam_width=self.beam_width,
                    temperature=self.temperature, top_k=self.top_k,
                    max_new_tokens=self.max_new_tokens,
                    no_repeat_n_grams=self.no_repeat_n_grams,
                    beam_expansion_factor=self.beam_expansion_factor,
                    eos_token_id=self.eos_token_id,
                    consolidation_temperature=self.consolidation_temperature,
                    length_boost=self.boost,
                    cross_kv_quant=self.cross_kv_quant)

    # -- per-round candidate scoring ------------------------------------------
    def _candidates(self, last_logits, ids_flat, cur_len, generator,
                    gumbel: Optional[torch.Tensor] = None):
        """(next_ids, log_scores), both (rows, bef).  ``gumbel`` replaces
        the noise: (rows, top_k) on the fused path, (rows, V) on the dense
        one."""
        bef = self.beam_expansion_factor
        fused = beam_candidates_with_ngram(
            last_logits, ids_flat, cur_len, self.no_repeat_n_grams,
            generator, self.temperature, self.top_k, bef, gumbel=gumbel)
        if fused is not None:
            next_id, log_scores = fused
        else:
            scores = apply_no_repeat_ngram(last_logits.float(), ids_flat,
                                           cur_len, self.no_repeat_n_grams)
            scores = apply_top_k(scores, self.top_k)
            if self.temperature <= 0:
                prob = torch.log_softmax(scores, dim=-1)
                next_id = topk(scores, bef)[1]
                log_scores = prob.gather(-1, next_id)
            else:
                prob = torch.log_softmax(scores / self.temperature, dim=-1)
                next_id, log_scores = gumbel_topk_sample(prob, bef, generator,
                                                         gumbel)
        if self.eos_token_id is not None:
            where_eos = ids_flat[:, cur_len - 1:cur_len] == self.eos_token_id
            sticky = where_eos & (log_scores + self.length_boost < 0)
            next_id = next_id.masked_fill(sticky, self.eos_token_id)
            log_scores = torch.where(sticky, torch.zeros_like(log_scores),
                                     log_scores + self.length_boost)
        return next_id, log_scores

    # -- consolidation --------------------------------------------------------
    def _consolidate(self, cum, next_ids, next_scores, generator):
        """(beams_idx (bs, bw), chosen ids (bw, bs), chosen scores (bw, bs))
        from bw·bef candidates per sample."""
        bw, bs, bef = next_ids.shape
        expanded = (cum[:, :, None] + next_scores).transpose(0, 1).reshape(
            bs, bw * bef)
        if self.consolidation_temperature <= 0:
            best_pos = topk(expanded, bw)[1]
        else:
            logp = torch.log_softmax(
                expanded / self.consolidation_temperature, dim=-1)
            best_pos = gumbel_topk_sample(logp, bw, generator)[0]
        chosen_ids = next_ids.transpose(0, 1).reshape(bs, bw * bef).gather(
            -1, best_pos)
        chosen_scores = next_scores.transpose(0, 1).reshape(
            bs, bw * bef).gather(-1, best_pos)
        return best_pos // bef, chosen_ids.T, chosen_scores.T

    # -- the rounds -----------------------------------------------------------
    def _start(self, encoder_output, prompt_ids):
        """The tiled encoder output (bw · bs, n_cls, d), the id buffer
        (bw, bs, T) holding the prompt, the scores (bw, bs), t0 and T."""
        bw, dev = self.beam_width, encoder_output.device
        bs, n_cls, n_embd = encoder_output.shape
        x = encoder_output[None].expand(bw, bs, n_cls, n_embd).reshape(
            bw * bs, n_cls, n_embd)
        t0 = prompt_ids.shape[-1]
        total = self.max_new_tokens + t0 - 1
        ids_buf = torch.zeros((bw, bs, total), dtype=torch.long, device=dev)
        ids_buf[:, :, :t0] = prompt_ids.expand(bs, t0)
        cum = torch.zeros((bw, bs), dtype=torch.float32, device=dev)
        return x, ids_buf, cum, t0, total

    def _prefill(self, x, ids_buf, t0: int, total: int):
        """The cached branch's start: (cache, cross, cross K/V in the
        call's mode, the prefill's last logits)."""
        model = self.model
        bw, bs = ids_buf.shape[:2]
        cross = x if model.use_cross_attn else None
        cross_kv = precompute_cross_kv(model, cross)
        logits, cache = prefill(model, x, ids_buf[:, :, :t0].reshape(
            bw * bs, t0), total, cross_kv)
        cross_kv = quantize_cross_kv(cross_kv, self.cross_kv_quant)
        return cache, cross, cross_kv, logits[:, -1]

    def _round(self, ids_buf, cum, last, cur_len: int, generator, cache,
               cross, cross_kv, encoder_output, axis=None):
        """One round at ``cur_len``: candidates, consolidation, the
        gathers, the chosen ids written and the next logits (a cached
        decoder step, or the fallback's re-forward where ``cache`` is
        None).  Returns (ids_buf, cum, last), new tensors."""
        bw, bs, total = ids_buf.shape
        bef = self.beam_expansion_factor
        next_ids, next_scores = self._candidates(
            last, ids_buf.reshape(bw * bs, total), cur_len, generator)
        beams_idx, chosen_ids, chosen_scores = self._consolidate(
            cum, next_ids.reshape(bw, bs, bef),
            next_scores.reshape(bw, bs, bef), generator)
        # new beam (nb, b) takes old beam beams_idx[b, nb]
        src = beams_idx.T
        if axis is not None:
            beams_agree(axis, src, chosen_ids)
            self.agreed += 1
        ids_buf = ids_buf.gather(0, src[:, :, None].expand(bw, bs, total))
        cum = cum.gather(0, src) + chosen_scores
        ids_buf[:, :, cur_len] = chosen_ids
        if cache is None:
            return ids_buf, cum, self._full_logits(ids_buf, cur_len + 1,
                                                   encoder_output)
        # cross K/V need no reorder: every beam of a sample shares it
        rows = torch.arange(bs, device=ids_buf.device)[None, :]
        cache.gather_batch((src * bs + rows).reshape(-1))
        logits, cache = decoder_step(self.model, chosen_ids.reshape(-1, 1),
                                     cache,
                                     self.model.space_for_prompt + cur_len,
                                     cross, cross_kv)
        return ids_buf, cum, logits[:, -1]

    def cached_rounds(self, images, encoder_output, prompt_ids: torch.Tensor,
                      ids_out: torch.Tensor, scores_out: torch.Tensor,
                      taken: torch.Tensor, generator) -> None:
        """The cached branch of a call as one function that reads nothing
        back to the host (the beam counterpart of
        ``generation.cached_call``; the graph route captures it with its
        arguments as the graph's static buffers): from ``images`` (the
        encoder runs here) or ``encoder_output``, and the prompt (bs, t0),
        it writes the ids into ``ids_out`` (bs, bw, T), the scores into
        ``scores_out`` (bs, bw) and the rounds taken into ``taken`` (a
        0-d int64).  Every round of the window runs; the done flag is
        JAX's ``not_done`` on the device, and a round entered with it set
        leaves the ids and scores as they were."""
        model = self.model
        if encoder_output is None:
            encoder_output = model.encoder(images)
        x, ids_buf, cum, t0, total = self._start(encoder_output, prompt_ids)
        cache, cross, cross_kv, last = self._prefill(x, ids_buf, t0, total)
        eos = self.eos_token_id
        taken.fill_(total - t0 if eos is None else 0)
        for cur_len in range(t0, total):
            new_ids, new_cum, last = self._round(
                ids_buf, cum, last, cur_len, generator, cache, cross,
                cross_kv, encoder_output)
            if eos is None:
                ids_buf, cum = new_ids, new_cum
                continue
            done = self._done(ids_buf, cur_len)
            ids_buf = torch.where(done, ids_buf, new_ids)
            cum = torch.where(done, cum, new_cum)
            taken.add_((~done).to(taken.dtype))
        if eos is not None:
            past = torch.arange(total, device=ids_buf.device) >= t0 + taken
            ids_buf = ids_buf.masked_fill(past, eos)
        ids_out.copy_(ids_buf.transpose(0, 1))
        scores_out.copy_(cum.T)

    @torch.no_grad()
    def __call__(self, images, decoded_ids: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 encoder_output: Optional[torch.Tensor] = None,
                 graphs: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Beam-search captions of ``images`` (or of ``encoder_output``)
        from the prompt ``decoded_ids`` ((bs, t0) or (t0,)), on the model's
        device: ids (bs, bw, T) and scores (bs, bw).  Where
        ``graphs.graph_plan`` allows it the call replays a captured CUDA
        graph of :meth:`cached_rounds`, the same ids and scores bit for
        bit; ``graphs=False`` keeps the eager route."""
        # imported here: models/graphs.py imports this module
        from image2text_torch.models.graphs import graph_plan, graphed_beam

        model = self.model
        dec, dev = model.decoder, model.device
        if not getattr(dec, "is_causal", True):
            raise ValueError(
                "Beam search needs a causal decoder: with a bidirectional "
                "decoder every position's logits see the whole fixed-size "
                "id buffer, so the cached and fallback decode paths would "
                "leak unwritten future slots. Use generate (which has an "
                "exact growing-sequence path) for such models.")
        decoded_ids = decoded_ids.to(dev)
        if decoded_ids.dim() == 1:
            decoded_ids = decoded_ids[None]
        t0 = decoded_ids.shape[-1]
        self.agreed = 0
        route, _ = graph_plan(model, dev, prompt_len=t0,
                              max_new_tokens=self.max_new_tokens,
                              graphs=graphs, beam=True)
        if route == "graph":
            ids, scores, self.rounds_taken = graphed_beam(
                model, self, images, encoder_output, decoded_ids, generator)
            self.rounds = self.max_new_tokens - 1
            return ids, scores
        axis = model_axis(model)
        if axis is not None and generator is None and (
                self.temperature > 0 or self.consolidation_temperature > 0):
            generator = group_generator(axis, dev)
        if encoder_output is None:
            encoder_output = model.encoder(images.to(dev))
        x, ids_buf, cum, t0, total = self._start(encoder_output, decoded_ids)
        off = model.space_for_prompt
        use_cache = getattr(dec, "supports_kv_cache", False)
        exact = getattr(dec, "cache_exact_for_window", None)
        if use_cache and exact is not None:
            use_cache = exact(off + t0, off + total)
        if use_cache:
            cache, cross, cross_kv, last = self._prefill(x, ids_buf, t0,
                                                         total)
        else:
            cache = cross = cross_kv = None
            last = self._full_logits(ids_buf, t0, encoder_output)
        cur_len = t0
        eos = self.eos_token_id
        while cur_len < total and not (
                eos is not None and bool(self._done(ids_buf, cur_len))):
            ids_buf, cum, last = self._round(ids_buf, cum, last, cur_len,
                                             generator, cache, cross,
                                             cross_kv, encoder_output, axis)
            cur_len += 1
        self.rounds = cur_len - t0
        self.rounds_taken = torch.full((), self.rounds, dtype=torch.long,
                                       device=dev)
        self._skip_draws(generator, ids_buf.shape[1], last.shape[-1], dev,
                         total - cur_len)
        if eos is not None:
            ids_buf[:, :, cur_len:] = eos
        return ids_buf.transpose(0, 1), cum.T

    def _skip_draws(self, generator, bs: int, vocab: int, device,
                    rounds: int) -> None:
        """Draw and drop the noise of ``rounds`` rounds (the calls a round
        makes, in its order: the candidates' Gumbel noise over the top-k
        head or over the vocabulary, then the consolidation's), so that
        the eager route leaves ``generator`` where the graph route, which
        runs every round of the window, leaves it."""
        bw, bef, k = self.beam_width, self.beam_expansion_factor, self.top_k
        fused = k is not None and bef <= min(k, vocab)
        for _ in range(rounds):
            if self.temperature > 0:
                gumbel_noise((bw * bs, min(k, vocab) if fused else vocab),
                             generator, device)
            if self.consolidation_temperature > 0:
                gumbel_noise((bs, bw * bef), generator, device)

    @torch.no_grad()
    def caption(self, frames_u8: torch.Tensor, decoded_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                graphs: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """The beam serving path: raw uint8 frames (B, H, W, 3) →
        resize/normalize on the model's device in the model's dtype
        (``generation.preprocess_frames``, outside any graph) →
        encoder → beam search, on the route ``graphs`` allows."""
        model = self.model
        images = preprocess_frames(model, frames_u8.to(model.device),
                                   model.decoder.dtype)
        return self(images, decoded_ids, generator, graphs=graphs)

    def _full_logits(self, ids_buf, cur_len: int, encoder_output):
        """The fallback: the whole (bw, bs, T) buffer re-forwarded with
        ``sparse_rule_len`` at the current length; the logits at
        ``cur_len - 1`` (bw · bs, V)."""
        bw, bs, total = ids_buf.shape
        enc = encoder_output[None].expand(bw, *encoder_output.shape).reshape(
            bw * bs, *encoder_output.shape[1:])
        out = self.model(None, ids_buf.reshape(bw * bs, total),
                         encoder_output=enc,
                         sparse_rule_len=self.model.space_for_prompt
                         + cur_len)
        return out.logits[:, cur_len - 1]

    def _done(self, ids_buf, cur_len: int) -> torch.Tensor:
        """JAX's ``not_done``, negated, on the device (a 0-d bool): whether
        every beam holds an EOS among its first ``cur_len`` ids; the
        callers ask only with an EOS id."""
        return (ids_buf[:, :, :cur_len] == self.eos_token_id).any(-1).all()
