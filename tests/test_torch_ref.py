"""The port's oracle (``repro_torch.kernels.ref``) against the JAX package's
``repro.kernels.ref.simulate_reference``, bit for bit, over the shape sweep
of ``tests/test_kernels.py`` and both scan modes."""
import numpy as np
import pytest

from repro.core.config import MarketConfig as JConfig
from repro.kernels import ref as j_ref
from repro_torch.core.config import MarketConfig
from repro_torch.kernels import ref

FIELDS = ("bid", "ask", "last_price", "prev_mid", "price_path", "volume_path")


@pytest.mark.parametrize("scan", ["cumsum", "hillis-steele"])
@pytest.mark.parametrize("M,A,L,S", [
    (4, 8, 16, 5),
    (8, 16, 32, 10),
    (16, 33, 64, 8),     # A not divisible by L
    (6, 128, 128, 6),    # A == L (the paper's grid size)
    (2, 300, 256, 4),    # A > 2L
    (32, 5, 8, 12),      # tiny L
])
def test_oracle_matches_jax_reference(M, A, L, S, scan):
    kw = dict(num_markets=M, num_agents=A, num_levels=L, num_steps=S,
              seed=M * 1000 + A)
    want = j_ref.simulate_reference(JConfig(**kw), scan=scan).to_numpy()
    got = ref.simulate_reference(MarketConfig(**kw), scan=scan,
                                 device="cpu").to_numpy()
    for f in FIELDS:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        assert (g == w).all(), f"{f} differs at {(M, A, L, S, scan)}"


def test_population_mix_sweep():
    for amom in (0.0, 0.3, 0.7):
        kw = dict(num_markets=4, num_agents=40, num_levels=32, num_steps=10,
                  alpha_momentum=amom, seed=3)
        want = j_ref.simulate_reference(JConfig(**kw)).to_numpy()
        got = ref.simulate_reference(MarketConfig(**kw), device="cpu")
        for f in FIELDS:
            assert (got.to_numpy()[FIELDS.index(f)]
                    == np.asarray(getattr(want, f))).all(), (amom, f)


def test_reference_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        ref.simulate_reference(MarketConfig(num_markets=2, num_agents=4,
                                            num_levels=8, num_steps=2))
