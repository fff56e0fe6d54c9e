"""The scratch-encoder HF-family configurations end to end, the port
against the JAX package on the CPU: tiny forms (``tests/torch_hf_pairs.py``)
of ``tpu/falcon-7b.yaml`` (the sparse MQA/MoE encoder, int4 + LoRA
Falcon-7B: one K/V head, parallel attention) and ``tpu/gpt2-xl.yaml``
(the same encoder, int4 + LoRA GPT-2-xl with cross-attention and the soft
prompt).  The tests are ``test_torch_hf_models.py``'s, run here on these
two configurations (its ``pytest_generate_tests`` reads this module's
``NAMES``).
"""
from test_torch_hf_models import (  # noqa: F401  (collected here)
    pairs, pytest_generate_tests, test_builds_at_full_size_from_the_yaml,
    test_cached_decode_matches_full_forward,
    test_checkpoint_round_trip_through_jax,
    test_first_step_logits_match_jax,
    test_greedy_generate_32_tokens_token_for_token,
    test_state_dict_keys_and_values_match_jax)

NAMES = ["falcon7b", "gpt2xl"]
