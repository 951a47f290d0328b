"""Codon alphabet: DNA triplets -> 61 sense-codon one-hot states (port
of phylo_tpu/dataio/codons.py, NumPy only, copied so the port never
imports the JAX package).

Codon substitution models (models/codon.py, GY94 family) operate on the
61 sense codons of the standard genetic code (64 triplets minus the
stop codons TAA / TAG / TGA).  This module builds the static code
tables and converts nucleotide alignments into codon-state arrays with
the same missing-data convention the DNA path uses (reference
runner.py:91-96: gaps/ambiguity -> all-ones rows).

The reference framework is DNA-only; this is an extension in the same
family as the protein alphabet support.
"""

from __future__ import annotations

import numpy as np

_NT = "TCAG"        # classic codon-table ordering (TTT first)
_STOPS = ("TAA", "TAG", "TGA")

# standard genetic code, codon-table order over TCAG^3
_AA_TABLE = (
    "FFLLSSSSYY**CC*W"    # TTT TTC TTA TTG TCT ... TGG
    "LLLLPPPPHHQQRRRR"
    "IIIMTTTTNNKKSSRR"
    "VVVVAAAADDEEGGGG"
)


def _all_triplets():
    return [a + b + c for a in _NT for b in _NT for c in _NT]


#: the 61 sense codons, in TCAG-table order (class-level constants)
SENSE_CODONS = tuple(t for t in _all_triplets() if t not in _STOPS)

#: amino acid (one-letter) per sense codon
CODON_AA = tuple(
    _AA_TABLE[i] for i, t in enumerate(_all_triplets())
    if t not in _STOPS
)

_CODON_INDEX = {c: i for i, c in enumerate(SENSE_CODONS)}

# nucleotide -> indicator over TCAG (IUPAC ambiguity codes included;
# gaps and unknowns are fully ambiguous, matching the DNA loaders)
_NT_CODES = {
    "T": "T", "C": "C", "A": "A", "G": "G", "U": "T",
    "R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG",
    "N": "ACGT", "-": "ACGT", "?": "ACGT", ".": "ACGT",
}


def _nt_mask(ch):
    try:
        allowed = _NT_CODES[ch.upper()]
    except KeyError:
        raise ValueError(f"unknown nucleotide symbol {ch!r}") from None
    return np.array([n in allowed for n in _NT], dtype=np.float64)


def encode_codon_strings(seqs):
    """{taxon: DNA string} -> (taxa, (N, S/3, 61) codon one-hot).

    Sequence length must be a multiple of 3 (a reading frame is the
    caller's responsibility).  A triplet with ambiguity codes gets ones
    at every sense codon consistent with the per-position indicators
    (the product measure restricted to sense codons); a triplet
    consistent ONLY with stop codons (or fully ambiguous) becomes
    missing data (all-ones), matching the DNA all-ones convention.
    """
    taxa = list(seqs)
    lengths = {len(seqs[t]) for t in taxa}
    if len(lengths) != 1:
        raise ValueError(f"unequal sequence lengths: {sorted(lengths)}")
    (L,) = lengths
    if L % 3:
        raise ValueError(f"sequence length {L} is not a multiple of 3")
    S = L // 3
    A = len(SENSE_CODONS)
    out = np.zeros((len(taxa), S, A))
    # (61, 3, 4) indicator of each sense codon's nucleotides
    codon_nt = np.zeros((A, 3, 4))
    for ci, codon in enumerate(SENSE_CODONS):
        for pos, ch in enumerate(codon):
            codon_nt[ci, pos, _NT.index(ch)] = 1.0
    for ti, taxon in enumerate(taxa):
        s = seqs[taxon]
        for si in range(S):
            tri = s[3 * si: 3 * si + 3]
            masks = np.stack([_nt_mask(ch) for ch in tri])   # (3, 4)
            # codon allowed iff every position's nucleotide is allowed
            allowed = np.prod(
                (codon_nt * masks[None]).sum(-1), axis=-1)   # (61,)
            if allowed.sum() == 0:
                allowed = np.ones(A)               # stop-only: missing
            out[ti, si] = allowed
    return taxa, out


def codon_dataset(ds):
    """Convert a DNA `PhyloDataset` (one-hot over ACGT) to the codon
    alphabet.  Columns beyond the last full triplet are dropped, and
    the drop is recorded in the dataset name
    (``<name>_codon_drop2nt``)."""
    from phylo_tpu_torch.dataio.datasets import PhyloDataset

    genome = np.asarray(ds.genome)
    N, S, A = genome.shape
    if A != 4:
        raise ValueError(f"codon conversion needs a DNA dataset, A={A}")
    # decode one-hot/ambiguous rows back to strings via masks
    S3 = (S // 3) * 3
    taxa = list(ds.taxa)
    seqs = {}
    rev = {(1., 0., 0., 0.): "A", (0., 1., 0., 0.): "C",
           (0., 0., 1., 0.): "G", (0., 0., 0., 1.): "T"}
    # dataio one-hot order is ACGT (alphabets.DNA_ALPHABET)
    for ti, t in enumerate(taxa):
        chars = []
        for si in range(S3):
            row = tuple(np.round(genome[ti, si], 6))
            ch = rev.get(row)
            if ch is None:
                # ambiguity: map the ACGT indicator to an allowed set
                allowed = "".join(
                    n for n, v in zip("ACGT", genome[ti, si]) if v > 0)
                inv = {"AG": "R", "CT": "Y", "CG": "S", "AT": "W",
                       "GT": "K", "AC": "M", "CGT": "B", "AGT": "D",
                       "ACT": "H", "ACG": "V", "ACGT": "N"}
                ch = inv.get(allowed, "N")
            chars.append(ch)
        seqs[t] = "".join(chars)
    taxa, onehot = encode_codon_strings(seqs)
    name = f"{ds.name}_codon"
    if S3 != S:
        name += f"_drop{S - S3}nt"
    return PhyloDataset(name=name, taxa=taxa, genome=onehot)


def empirical_codon_frequencies(genome, *, pseudocount=1.0):
    """F61-style empirical codon frequencies from the encoded data:
    unambiguous codon counts + a pseudocount, normalized.  Ambiguous /
    missing rows (sum > 1) are skipped."""
    g = np.asarray(genome)
    # tolerance, not exact equality: one-hot rows that passed through a
    # float32 cast or renormalization still count as unambiguous
    is_certain = np.isclose(g.sum(-1), 1.0, atol=1e-3)    # (N, S)
    counts = (g * is_certain[..., None]).sum((0, 1))
    freqs = counts + pseudocount
    return freqs / freqs.sum()
