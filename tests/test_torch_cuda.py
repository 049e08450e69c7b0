"""The CUDA kernel against its plain PyTorch version on the card.

Marked ``cuda``: they need an NVIDIA card and ``nvcc``, and skip without a
card. On the card: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.core import params as params_mod
from repro_torch.core.config import MarketConfig
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.session import Engine
from repro_torch.core.stats import init_stats
from repro_torch.core.step import initial_state
from repro_torch.kernels import kinetic_clearing as kc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _spec(M, A, L, S=40):
    blocks = [MarketConfig(num_markets=M, num_agents=A, num_levels=L,
                           num_steps=S, seed=2**31 + L, **mix)
              for mix in ({"alpha_fundamentalist": 0.2},
                          {"alpha_whale": 0.2, "whale_period": 3},
                          {"alpha_hft": 0.2, "hft_threshold": 0.1},
                          {"alpha_informed": 0.2, "shock_step": 6,
                           "shock_intensity": 0.5, "shock_cancel": 0.5},
                          {"alpha_arbitrageur": 0.3})]
    spec = EnsembleSpec.concatenate([EnsembleSpec.homogeneous(b)
                                     for b in blocks])
    n = spec.num_markets
    return spec.with_values(coupling_peer=[(m + 1) % n for m in range(n)])


@pytest.mark.parametrize("M,A,L", [(4, 256, 128), (2, 300, 1024),
                                   (8, 5, 8)])
@pytest.mark.parametrize("stats_only", [False, True])
def test_kernel_equals_plain(cuda, M, A, L, stats_only):
    spec = _spec(M, A, L)
    state = initial_state(spec, cuda)
    params = params_mod.pack_params(spec.params, cuda)
    gen = torch.Generator().manual_seed(L)
    ext = [(torch.randint(0, 3, (spec.num_markets, L), generator=gen)
            .float().to(cuda)) for _ in range(2)]
    kw = dict(cfg=spec, chunk=16, params=params, stats_only=stats_only,
              stats=init_stats(spec.num_markets, cuda) if stats_only
              else None)
    got = kc.kinetic_clearing_chunk(*state, 3, 12, *ext, **kw)
    want = kc.kinetic_clearing_chunk_plain(*state, 3, 12, *ext, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    rest = zip(got[4], want[4]) if stats_only else \
        ((g[:, :12], w[:, :12]) for g, w in zip(got[4:], want[4:]))
    for g, w in rest:
        assert torch.equal(g, w)


def test_session_launches_once_per_chunk(cuda):
    spec = _spec(4, 64, 32, S=50)
    kc.kinetic_clearing_chunk.launches = 0
    with Engine("cuda-kinetic", device=cuda).open(spec, chunk_size=16) as s:
        got = s.run_to_result()
    assert kc.kinetic_clearing_chunk.launches == 4
    with Engine("cuda-kinetic", device="cpu").open(spec,
                                                   chunk_size=16) as s:
        want = s.run_to_result()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
