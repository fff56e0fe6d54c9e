"""Offline evaluation CLI of the port, the twin of the repository's
``evaluate.py``: load a config and a checkpoint, stream val rows, generate
candidate captions per image (sampling or beam search), print them
against the ground truths, and compute corpus BLEU-4 and CIDEr-D.

    python -m image2text_torch.evaluate \\
        --config_file training_configs/local/synthetic-quality2.yaml \\
        [--chkpt_file artifacts/quality2_ck.npz] [--num_images 20] \\
        [--num_candidates 8] [--beam_search] [--top_k 16] [--temperature 1.0]

It runs on the card; a caller may pass ``device='cpu'`` to :func:`main`.
``--int8_serving`` gives the decoder its W8A8 serving form
(``models/quantization.py::int8_serving_params`` at its default
``min_elems``) and decodes against int8 cross-attention K/V;
``--approx_topk`` sets the sampler's approximate-top-k flag, which the
port takes as exact (``models/sampling.py``).
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser

import torch

from image2text_torch.configs.reader import load_training_config
from image2text_torch.eval.metrics import cider_d, corpus_bleu
from image2text_torch.models.generation_utils import BeamSearchTokenGenerator
from image2text_torch.models.quantization import int8_serving_params
from image2text_torch.models.vision_encoder_decoder import VisionEncoderDecoder
from image2text_torch.trainer import build_inner_datasets, config_tokenizer
from image2text_torch.training.data import normalize_label


def _strip(ids, eos):
    out = []
    for t in ids:
        if t == eos:
            break
        out.append(int(t))
    return out


def main(args, device=None) -> dict:
    """Evaluate as ``args`` say, on the card (``device`` None) or on
    ``device``: {"bleu", "cider", "candidates", "references"} (the
    candidates' and references' token ids, EOS cut)."""
    config = load_training_config(args.config_file)
    if args.chkpt_file:
        config.model.chkpt_path = args.chkpt_file
    tokenizer = config_tokenizer(config)
    model = VisionEncoderDecoder(config.model, device=device).init_weights(
        config.seed)
    if args.int8_serving:
        # W8A8 decoder weights; the generation paths also get int8
        # cross-KV below (lossy: the serving mode's quality cost)
        int8_serving_params(model.decoder)
    quant = "int8" if args.int8_serving else None
    dev = model.device

    # the inner dataset (pre-expansion batch dicts): every image scored
    # once against all five of its reference captions
    _, val_ds = build_inner_datasets(config, tokenizer)
    eos = tokenizer.eos_token_id
    prompt = torch.tensor([[tokenizer.bos_token_id]])
    window = model.decoder.block_size - model.space_for_prompt
    max_new = min(args.max_new_tokens, window - 1)
    if args.beam_search:
        beam = BeamSearchTokenGenerator(
            model, beam_width=args.num_candidates,
            temperature=args.temperature, top_k=args.top_k,
            max_new_tokens=max_new, eos_token_id=eos,
            no_repeat_n_grams=tuple(config.model.no_repeat_n_grams),
            consolidation_temperature=0.0, cross_kv_quant=quant)

    cands, refs = [], []
    gen = torch.Generator(device=dev).manual_seed(config.seed + 123)
    seen = 0
    for batch in val_ds:
        for row in range(batch["image"].shape[0]):
            if seen >= args.num_images:
                break
            img = torch.as_tensor(batch["image"][row:row + 1], device=dev)
            truths = []
            for c in range(5):
                lab = normalize_label(
                    batch[f"input_ids_{c}"][row:row + 1],
                    batch[f"attn_mask_{c}"][row:row + 1],
                    config.ignore_index)[0]
                truths.append(_strip(lab[lab != config.ignore_index], eos))
            if args.beam_search:
                ids, _ = beam(img, prompt, generator=gen)
                best = ids[0, 0, 1:].cpu().numpy()
            else:
                # num_candidates parallel samples; the metrics use
                # candidate 0 only (best-of-N would inflate them)
                x = img.expand(args.num_candidates, *img.shape[1:])
                out = model.generate(x, prompt, max_new_tokens=max_new,
                                     temperature=args.temperature,
                                     top_k=args.top_k, generator=gen,
                                     cross_kv_quant=quant,
                                     approx_top_k=args.approx_topk)
                best = out[0, 1:].cpu().numpy()
            cand = _strip(best, eos)
            cands.append(cand)
            refs.append(truths)
            if seen < 5:
                print(f"[{seen}] truth: {tokenizer.decode(truths[0])}")
                print(f"[{seen}] gen:   {tokenizer.decode(cand)}")
            seen += 1
        if seen >= args.num_images:
            break

    bleu = corpus_bleu(cands, refs)
    cider = cider_d(cands, refs)
    print(f"BLEU-4: {bleu:.4f}  CIDEr-D: {cider:.4f}  "
          f"({args.num_images} images)")
    return dict(bleu=bleu, cider=cider, candidates=cands, references=refs)


def parse_args(argv=None):
    p = ArgumentParser()
    p.add_argument("--config_file", required=True)
    p.add_argument("--chkpt_file", default=None)
    p.add_argument("--num_images", type=int, default=20)
    p.add_argument("--num_candidates", type=int, default=4)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=16)
    p.add_argument("--beam_search", action="store_true")
    p.add_argument("--int8_serving", action="store_true",
                   help="W8A8 decoder weights + int8 cross-KV (lossy "
                        "serving mode)")
    p.add_argument("--approx_topk", action="store_true",
                   help="approximate top-k sampling (taken as exact by the "
                        "port: no op on the card computes approx_max_k)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))
