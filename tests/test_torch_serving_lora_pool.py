"""The port's LoRA ServingEngine in lockstep with the JAX engine on the
CPU (cases: tests/torch_serving_lora_cases.py) where the block pool is
the point: an int8 pool under ``quantize_params`` weights (adapters over
an int8 base), and a starved pool whose preemptions unpin an adapter and
re-acquire it on resume.  Tokens, finish reasons, block ledger and pool
counters identical after every step."""

from torch_serving_lora_cases import _engines, _lockstep, _oracle, _requests


def test_lora_engine_int8_pool_quantized_weights_matches_jax():
    """S-LoRA over an int8 base: quantize_params weights, int8 pool."""
    je, te, jpool, tpool = _engines("paged", "int8", quant=True)
    _lockstep(je, te, jpool, tpool, _requests(seed=4, n=12))


def test_lora_engine_starved_pool_preempts_like_jax():
    """A 10-block pool: decode preempts, the victim unpins its adapter and
    re-acquires it on resume."""
    je, te, jpool, tpool = _engines("paged", num_blocks=10)
    reqs = _requests(seed=5, n=10)
    done, _ = _lockstep(je, te, jpool, tpool, reqs)
    assert te.stats()["preemptions"] >= 1
    assert sum(r.preemptions for r in done.values()) >= 1
    _oracle(reqs, done)
