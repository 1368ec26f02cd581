"""The port's audio family (whisper-base: ``enc_mlp`` encoder layers over
stub frame embeddings, ``cross_mlp`` decoder layers) against the JAX
package on the CPU, reduced (2 encoder and 2 decoder layers, 8 frames,
d_model 128, float32); the checks and their tolerances are in
``tests/_torch_frontend.py``: prefill logits and the caches ``k``, ``v``,
``ek``, ``ev`` and four greedy decode steps at 1e-4, ``loss_fn`` and its
gradient (the encoder's leaves among them), the interop round trip, a
bf16 build's weights bit for bit, decode against the port's own prefill
at 5e-3, two trainer rounds against the reference's, and the serve and
train entry points on the CPU.
"""
import numpy as np

import _torch_frontend as FE

ARCH = "whisper-base"


def test_prefill_cache_and_greedy_decode_match():
    FE.check_prefill_and_decode(ARCH)


def test_loss_fn_value_and_grad_match_reference():
    grads = FE.check_loss_and_grads(ARCH)
    # the gradient reaches the encoder through the cross attention
    enc = grads["encoder"][0]
    assert np.abs(enc["attn"]["wq"]).max() > 0
    assert np.abs(grads["enc_norm"]["scale"]).max() > 0


def test_model_params_round_trip_with_the_encoder():
    tp = FE.check_round_trip(ARCH, n_encoder_layers=3)
    assert len(tp["encoder"]) == 3 and len(tp["layers"]) == 4


def test_bfloat16_weights_cross_bit_for_bit():
    FE.check_bfloat16(ARCH)


def test_decode_agrees_with_its_prefill():
    FE.check_decode_consistency(ARCH)


def test_init_cache_matches_prefill_layout():
    FE.check_init_cache_layout(ARCH)


def test_prefill_flash_calls(monkeypatch):
    """One non-causal flash call per encoder layer over the frames, then
    per decoder layer a causal self-attention call and a non-causal cross
    call from the tokens to the frames."""
    cfg, calls = FE.flash_calls(monkeypatch, ARCH)
    F, S = cfg.n_frontend_tokens, FE.SRV.S + 1
    assert calls == [(F, F, False)] * cfg.n_encoder_layers + \
        [(S, S, True), (S, F, False)] * cfg.n_layers


def test_train_step_matches_reference():
    FE.check_trainer_round(ARCH)


def test_serve_cli_runs_on_the_cpu():
    FE.check_serve_cli(ARCH)


def test_launch_train_main_runs_on_the_cpu():
    state = FE.check_launch_train(ARCH)
    assert len(state.s_hat["encoder"]) == 2
