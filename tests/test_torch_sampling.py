"""PyTorch port, ``serve/sampling.py``, against the JAX reference.

``filter_logits`` is deterministic and is compared value for value. Draws
cannot equal ``jax.random``'s, so ``sample_logits`` is held to the
filtered softmax by the frequencies of many seeded draws."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.serve import sampling as JS
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import (
    sampling as TS)


def _both(logits, temperature, top_k, top_p):
    ref = np.asarray(JS.filter_logits(
        jnp.asarray(logits), jnp.asarray(temperature, jnp.float32),
        jnp.asarray(top_k, jnp.int32), jnp.asarray(top_p, jnp.float32)))
    out = TS.filter_logits(torch.from_numpy(logits),
                           torch.tensor(temperature, dtype=torch.float32),
                           torch.tensor(top_k), torch.tensor(top_p,
                                                             dtype=torch.float32))
    return out.numpy(), ref


class TestFilterLogits:
    def test_matches_reference(self):
        rng = np.random.default_rng(0)
        logits = (rng.normal(size=(8, 64)) * 3).astype(np.float32)
        # greedy temperature 0, top-k only, top-p only, both, p edges
        temperature = [0.0, 1.0, 0.7, 1.3, 0.5, 1.0, 2.0, 1.0]
        top_k = [0, 5, 0, 10, 3, 0, 1, 64]
        top_p = [1.0, 1.0, 0.9, 0.5, 0.95, 0.0, 1.0, 1e-9]
        out, ref = _both(logits, temperature, top_k, top_p)
        np.testing.assert_array_equal(out == -1e30, ref == -1e30)
        np.testing.assert_allclose(out, ref, rtol=1e-6)

    def test_ties_at_the_top_k_threshold_are_kept(self):
        logits = np.array([[5.0, 3.0, 3.0, 3.0, 1.0, 0.0],
                           [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
        out, ref = _both(logits, [1.0, 1.0], [2, 1], [1.0, 1.0])
        np.testing.assert_allclose(out, ref, rtol=1e-6)
        # k = 2 keeps the head and all three tied values at the threshold
        assert (out[0] > -1e30).tolist() == [True, True, True, True, False,
                                             False]
        assert (out[1] > -1e30).all()

    def test_top_p_keeps_the_head_and_the_smallest_prefix(self):
        logits = np.log(np.array([[0.5, 0.3, 0.15, 0.05]], np.float32))
        for p, kept in [(1e-9, 1), (0.5, 1), (0.51, 2), (0.81, 3),
                        (1.0, 4)]:
            out, ref = _both(np.repeat(logits, 1, 0), [1.0], [0], [p])
            np.testing.assert_allclose(out, ref, rtol=1e-6)
            assert int((out > -1e30).sum()) == kept, p


class TestSampleLogits:
    def test_greedy_rows_take_the_argmax_and_draw_nothing(self):
        rng = np.random.default_rng(1)
        logits = torch.from_numpy(rng.normal(size=(5, 40)).astype(np.float32))
        gen = torch.Generator().manual_seed(0)
        state = gen.get_state()
        out = TS.sample_logits(gen, logits, torch.zeros(5), torch.zeros(5,
                               dtype=torch.int64), torch.ones(5))
        assert out.dtype == torch.int32
        assert torch.equal(out.long(), logits.argmax(-1))
        assert torch.equal(gen.get_state(), state)

    def test_mixed_rows(self):
        rng = np.random.default_rng(2)
        logits = torch.from_numpy(rng.normal(size=(4, 40)).astype(np.float32))
        gen = torch.Generator().manual_seed(3)
        temps = torch.tensor([0.0, 1.0, 0.0, 0.8])
        out = TS.sample_logits(gen, logits, temps,
                               torch.tensor([0, 1, 0, 0]), torch.ones(4))
        assert out[0] == logits[0].argmax() and out[2] == logits[2].argmax()
        # top_k = 1 keeps only the head
        assert out[1] == logits[1].argmax()

    @pytest.mark.parametrize("temperature,top_k,top_p", [
        (0.8, 0, 1.0), (1.0, 3, 1.0), (1.5, 0, 0.8)])
    def test_draws_follow_the_filtered_softmax(self, temperature, top_k,
                                               top_p):
        # 40,000 seeded draws; each token's frequency within 5 standard
        # errors of its probability (a chance of ~6e-7 per token to fail
        # on a correct sampler), and dropped tokens never drawn
        logits = torch.tensor([[2.0, 1.5, 1.0, 0.2, -0.5, -1.0]])
        rows = 4000
        probs = torch.softmax(TS.filter_logits(
            logits, temperature, top_k, top_p), dim=-1)[0].double().numpy()
        gen = torch.Generator().manual_seed(11)
        counts = np.zeros(logits.shape[1])
        for _ in range(10):
            out = TS.sample_logits(gen, logits.expand(rows, -1),
                                   torch.full((rows,), temperature),
                                   torch.full((rows,), top_k),
                                   torch.full((rows,), top_p))
            counts += np.bincount(out.numpy(), minlength=logits.shape[1])
        n = counts.sum()
        freq = counts / n
        se = np.sqrt(probs * (1 - probs) / n)
        assert np.all(np.abs(freq - probs) <= 5 * se + 1e-12), (freq, probs)
        assert np.all(counts[probs == 0] == 0)
