"""The rest of the serving tier on Whisper+xnor, in f32:
``generate_static`` (frames encoded in its prefill) = the dense wrapper
= the paged engine and the reference's static loop, temperature
sampling, a migration whose wire carries the raw frames and the
decoder's ``ctx_kv`` beside its self-attention blocks (mid-decode and
mid-chunked-prefill, where the destination encodes the frames again),
and the Router's kill drill."""

from test_torch_vlm_serve import (check_kill_drill,  # noqa: F401
                                  check_migration, check_static,
                                  check_tokens, params)
from test_torch_encdec_serve import ENCDEC


def test_static_dense_and_paged_agree(params):
    check_static(params, ENCDEC + "+xnor")


def test_temperature_sampling_matches_reference(params):
    check_tokens(params, ENCDEC + "+xnor", "float32", 7, 0, temperature=0.8)


def test_migration_carries_frames_and_ctx_kv(params, tmp_path):
    check_migration(params, ENCDEC + "+xnor", tmp_path)


def test_kill_drill_zero_divergence(params, tmp_path):
    check_kill_drill(params, ENCDEC + "+xnor", tmp_path)
