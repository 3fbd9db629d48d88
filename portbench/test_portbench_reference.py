"""The plain zone reference against the port on small zones on the CPU:
rows, syndrome stacks at r = 1, 2, 3, Fletcher tables and row digests
after commits, on a one-axis zone and on a (4, 2) mesh; its GF(2^32)
product against the port's."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from portbench.reference import zone as ref   # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gf_product():
    from repro_torch.core import gf
    g = torch.Generator().manual_seed(5)
    x = torch.randint(-2 ** 31, 2 ** 31, (4096,), generator=g,
                      dtype=torch.int64).to(torch.int32)
    for e in (0, 1, 7, 31, 32, 99, 198):
        c = ref.pow_g(e)
        assert c == gf.pow_g_int(e)
        assert torch.equal(ref.gf_mul_const(x, c), gf.mul_const(x, c))


@pytest.mark.parametrize("mesh,r", [((8, 1), 1), ((8, 1), 3),
                                    ((4, 2), 2), ((4, 2), 1)])
def test_zone_equals_port(mesh, r):
    from repro_torch import P, Pool, ProtectConfig, ZoneMesh
    g = torch.Generator().manual_seed(7)
    D, M = mesh
    state = {"a": torch.randn(D * 24, M * 48, generator=g),
             "b": torch.randn(6, M * 16, generator=g).to(torch.bfloat16),
             "c": torch.randn((), generator=g)}
    spec_lists = {"a": ["data", "model"], "b": [None, "model"], "c": []}
    specs = {k: P(*v) for k, v in spec_lists.items()}
    pool = Pool.open(state, specs,
                     mesh=ZoneMesh(mesh, ("data", "model")), device="cpu",
                     config=ProtectConfig(mode="mlpc", redundancy=r,
                                          block_words=32))
    for step in range(2):
        state = {k: v + 0.5 for k, v in state.items()}
        assert bool(pool.commit(state))
    prot = pool.prot
    got = {"row": prot.row, "synd": prot.synd, "cksums": prot.cksums,
           "digest": prot.digest}
    z = ref.Zone(state, spec_lists, sizes={"data": D, "model": M}, bw=32,
                 r=r, device=torch.device("cpu"))
    assert z.row_words == pool.protector.layout.row_words
    assert ref.compare(z, got) == {"row_words_off": 0, "stack_words_off": 0,
                                   "table_terms_off": 0,
                                   "digest_terms_off": 0}
    # one word off anywhere is seen
    got["synd"] = prot.synd.clone()
    got["synd"][(D - 1, M - 1, r - 1, 3)] ^= 1 << 30
    assert ref.compare(z, got)["stack_words_off"] == 1
