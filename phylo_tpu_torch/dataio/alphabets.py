"""Alphabet handling and one-hot sequence encoding.

Conventions follow the reference loaders (reference runner.py:83-97):

* DNA alphabet A/C/G/T in a fixed column order,
* case-insensitive lookup (the reference keeps separate upper/lower dicts),
* gap / missing characters ``-`` and ``?`` encode as all-ones rows
  (the standard "missing data" convention in Felsenstein pruning),
* the alphabet size A is whatever the data says (A=7 datasets such as
  spikeGP.p work unchanged, cf. reference vcsmc.py:118).

EXTENSION beyond the reference: the default gap set also treats the
IUPAC "any base" code ``N``/``n`` as missing data.  The reference's
Alphabet_dir_blank maps only ``-`` and ``?`` (runner.py:91-96) and
would KeyError on N; on alignments containing N, likelihoods under the
default therefore differ from what the reference convention would
produce (it would crash).  Pass ``gap_chars=REFERENCE_GAP_CHARS`` for
strict reference behavior in parity comparisons.
"""

from __future__ import annotations

import numpy as np

DNA_ALPHABET = "ACGT"
REFERENCE_GAP_CHARS = "-?"   # exactly the reference's blank set
GAP_CHARS = "-?Nn"           # + IUPAC N as missing (extension, see above)

# IUPAC nucleotide ambiguity codes -> the set of bases they stand for;
# encoded as multi-hot rows (standard Felsenstein ambiguous-data
# handling: the leaf's conditional likelihood is 1 for each compatible
# state).  The reference accepts none of these (it would KeyError).
DNA_AMBIGUITY = {
    "R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "U": "T",
}

# Amino acids, alphabetical one-letter order; an EXTENSION beyond the
# reference (DNA-only).  Works with every A-generic model (JC69, GTR,
# ReferenceQ, FixedQ) -- the alphabet size flows from the data, the
# same way the reference handles its A=7 spike dataset (vcsmc.py:118).
PROTEIN_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
PROTEIN_GAP_CHARS = "-?Xx*"
PROTEIN_AMBIGUITY = {
    "B": "DN",   # Asx
    "Z": "EQ",   # Glx
    "J": "IL",   # Xle
    "U": "C",    # selenocysteine: closest standard state
    "O": "K",    # pyrrolysine
}


def one_hot_rows(alphabet: str = DNA_ALPHABET,
                 gap_chars: str = GAP_CHARS,
                 ambiguity: dict | None = None) -> dict:
    """Character -> encoding row dict for ``alphabet``: one-hot for the
    alphabet itself, all-ones for every character in ``gap_chars``
    (missing data), and multi-hot rows for ``ambiguity`` codes (a map
    char -> compatible-state string)."""
    A = len(alphabet)
    rows = {}
    for i, ch in enumerate(alphabet):
        row = np.zeros(A)
        row[i] = 1.0
        rows[ch.upper()] = row
        rows[ch.lower()] = row
    for ch, states in (ambiguity or {}).items():
        row = np.zeros(A)
        for s in states:
            row[alphabet.index(s.upper())] = 1.0
        rows[ch.upper()] = row
        rows[ch.lower()] = row
    overlap = set(gap_chars.upper()) & set(alphabet.upper())
    if overlap:
        # e.g. the DNA default '-?Nn' against a custom amino-acid
        # ordering containing N: silently turning a real state into
        # missing data corrupts likelihoods -- fail loudly instead
        raise ValueError(
            f"gap_chars {sorted(overlap)} collide with alphabet "
            f"states; pass explicit gap_chars for this alphabet"
        )
    ones = np.ones(A)
    for ch in gap_chars:
        rows[ch] = ones
    return rows


def encode_strings(strings, alphabet: str = DNA_ALPHABET,
                   dtype=np.float64, gap_chars: str | None = None,
                   ambiguity: dict | None = None):
    """Encode equal-length sequences into an (N, S, A) multi-hot array.

    Equivalent to the reference's ``form_dataset_from_strings``
    (runner.py:107-115) but vectorized via a lookup table instead of a
    double Python loop.  ``gap_chars`` characters encode as all-ones
    (missing data); the DNA default includes N/n, which the reference
    does not accept -- use ``gap_chars=REFERENCE_GAP_CHARS`` for strict
    parity.  ``ambiguity`` maps IUPAC-style codes to compatible states
    (defaults: DNA_AMBIGUITY / PROTEIN_AMBIGUITY by alphabet).
    """
    if gap_chars is None:
        if alphabet == PROTEIN_ALPHABET:
            gap_chars = PROTEIN_GAP_CHARS
        elif alphabet == DNA_ALPHABET:
            gap_chars = GAP_CHARS
        else:
            # custom alphabets: only the universally-safe gap set (the
            # DNA default's N would collide with e.g. amino-acid
            # orderings containing asparagine)
            gap_chars = REFERENCE_GAP_CHARS
    if ambiguity is None:
        ambiguity = (PROTEIN_AMBIGUITY if alphabet == PROTEIN_ALPHABET
                     else DNA_AMBIGUITY if alphabet == DNA_ALPHABET
                     else {})
    if not strings:
        raise ValueError("need at least one sequence")
    S = len(strings[0])
    for s in strings:
        if len(s) != S:
            raise ValueError("sequences must have equal length")
    rows = one_hot_rows(alphabet, gap_chars, ambiguity)
    A = len(alphabet)
    # Build a 256-row lookup table indexed by character code.
    table = np.full((256, A), np.nan, dtype=dtype)
    for ch, row in rows.items():
        table[ord(ch)] = row
    codes = np.frombuffer("".join(strings).encode("latin-1"), dtype=np.uint8)
    out = table[codes].reshape(len(strings), S, A)
    if np.isnan(out).any():
        bad = sorted(
            {chr(c) for c in np.unique(codes) if np.isnan(table[c]).any()}
        )
        raise ValueError(f"characters not in alphabet {alphabet!r}: {bad}")
    return out
