"""The rest of the serving tier on Llama-3.2-Vision+xnor with contexts, in
f32: ``generate_static`` = the dense wrapper = the paged engine and the
reference's static loop, temperature sampling against the reference's
engine, a migration whose wire carries the context and ``ctx_kv``
(mid-decode and mid-chunked-prefill, 2 -> 1 slots; the reference
finishes the port's wire), and the Router's kill drill."""

from test_torch_vlm_serve import (VLM, check_kill_drill,  # noqa: F401
                                  check_migration, check_static,
                                  check_tokens, params)


def test_static_dense_and_paged_agree(params):
    check_static(params, VLM + "+xnor")


def test_temperature_sampling_matches_reference(params):
    check_tokens(params, VLM + "+xnor", "float32", 7, 0, temperature=0.8)


def test_migration_carries_ctx_and_ctx_kv(params, tmp_path):
    check_migration(params, VLM + "+xnor", tmp_path)


def test_kill_drill_zero_divergence(params, tmp_path):
    check_kill_drill(params, VLM + "+xnor", tmp_path)
