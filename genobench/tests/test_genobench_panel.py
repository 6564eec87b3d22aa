"""The benchmark's packer and frequencies equal the port's ``from_dense``."""
import numpy as np
import pytest
import torch

import toy  # noqa: F401  (puts the repo on sys.path)
from genobench import genotypes, panel
from miraculix_tpu_torch.geno import from_dense


@pytest.mark.parametrize("snps,indiv,unit", [
    (1000, 300, None),          # one unit
    (2100, 129, None),          # ragged rows and words
    (1000, 700, 128 * 1000),    # several units, planes of 128 rows
    (64, 3000, 384 * 64),       # units of 384 rows across 256-row planes
])
def test_packer_equals_from_dense(monkeypatch, snps, indiv, unit):
    if unit is not None:
        monkeypatch.setattr(genotypes, "UNIT_ELEMENTS", unit)
    spec = genotypes.Spec(snps, indiv, 2**33 + 7, 0.05, 0.5,
                          torch.device("cpu"))
    cols = [0, snps // 2, snps - 1]
    packed = panel.make(spec, columns=cols)
    dense = torch.cat([g for _, _, g in genotypes.units(spec)]).numpy()
    want = from_dense(dense, device="cpu")
    got = packed.geno
    assert torch.equal(got.zq_n, want.zq_n)
    assert torch.equal(got.zq_t, want.zq_t)
    assert torch.equal(got.freq, want.freq)
    assert torch.equal(got.pseudo_freq, want.pseudo_freq)
    assert np.array_equal(packed.columns.numpy(), dense[:, cols])


def test_genotypes_follow_the_law_and_the_seed():
    spec = genotypes.Spec(4000, 2000, 99, 0.05, 0.5, torch.device("cpu"))
    z = torch.cat([g for _, _, g in genotypes.units(spec)]).double()
    again = torch.cat([g for _, _, g in genotypes.units(spec)]).double()
    assert torch.equal(z, again)
    assert set(torch.unique(z).tolist()) <= {0.0, 1.0, 2.0}
    p = genotypes.allele_p(spec)
    assert float(p.min()) >= 0.05 and float(p.max()) <= 0.5
    # per SNP mean 2p and variance 2p(1 - p), pooled over SNPs
    assert abs(float((z.mean(0) - 2 * p).mean())) < 5e-3
    het = float((z == 1).double().mean())
    assert abs(het - float((2 * p * (1 - p)).mean())) < 5e-3
    other = genotypes.Spec(4000, 2000, 100, 0.05, 0.5, torch.device("cpu"))
    z2 = torch.cat([g for _, _, g in genotypes.units(other)]).double()
    assert not torch.equal(z, z2)
