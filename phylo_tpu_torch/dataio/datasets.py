"""Dataset registry and loaders.

Covers every dataset branch of the reference CLI (reference
runner.py:117-195): primate, primates_small (primate_data_wang), the Hohna
DS1-DS11 alignments (shipped zipped), fish, the betacoronavirus one-hot
pickles (including the A=7 spike dataset), simulated DNA, and literal
strings.  Datasets the reference references but does not ship
(coronavirus.p, ginkgo) raise a clear error instead of crashing at
pd.read_pickle time.
"""

from __future__ import annotations

import os
import pickle
import random
import zipfile
from dataclasses import dataclass, field

import numpy as np

from phylo_tpu_torch.dataio.alphabets import DNA_ALPHABET, encode_strings

def _default_data_root():
    """Dataset search order: $PHYLO_TPU_DATA, then the repo-local data/
    directory (vendored, with SHA256SUMS; re-creatable from a reference
    checkout via tools/vendor_data.py)."""
    env = os.environ.get("PHYLO_TPU_DATA")
    if env:
        return env
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(here, "data")


DEFAULT_DATA_ROOT = _default_data_root()

REFERENCE_STRINGS = ["ACTTTGAGAG", "ACTTTGACAG", "ACTTTGACTG", "ACTTTGACTC"]


@dataclass
class PhyloDataset:
    """taxa names + one-hot genomes, the `datadict` of the reference
    (vcsmc.py:104-108) as a typed object."""

    name: str
    taxa: list = field(repr=False)
    genome: np.ndarray = field(repr=False)  # (N, S, A)

    @property
    def N(self):
        return self.genome.shape[0]

    @property
    def S(self):
        return self.genome.shape[1]

    @property
    def A(self):
        return self.genome.shape[2]

    def __repr__(self):  # pragma: no cover
        return (
            f"PhyloDataset({self.name!r}, N={self.N}, S={self.S}, A={self.A})"
        )


def _read_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def dataset_from_strings(strings, taxa=None, name="strings",
                         alphabet=DNA_ALPHABET):
    genome = encode_strings(strings, alphabet)
    if taxa is None:
        taxa = [f"S{i}" for i in range(len(strings))]
    return PhyloDataset(name=name, taxa=list(taxa), genome=genome)


def dataset_from_arrays(genome, taxa=None, name="arrays"):
    """Wrap a reference-style ``datadict`` payload — an (N, S, A)
    one-hot genome array plus taxon names (reference vcsmc.py:104-108)
    — as a :class:`PhyloDataset`, the migration path for users carrying
    the reference's pickled dicts (e.g. the betacoronavirus sets).

    Accepts the reference's quirks, exactly as `load_dataset` does for
    the shipped pickles: a ``{'taxa': ..., 'genome': ...}`` (or
    ``'gemome'``, sic — betacorona2.p) dict passed as ``genome``, taxa
    wrapped in a 1-tuple (betacorona pickles), a taxa count that does
    not match N (betacorona1.p ships 16 names for 17 genomes —
    replaced with generated names), and all-zero observation rows
    (spikeGP.p — treated as missing data, the '-'/'?' all-ones
    convention of runner.py:91-96)."""
    user_taxa = taxa is not None
    if isinstance(genome, dict):
        d = genome
        genome = d.get("genome", d.get("gemome"))
        if genome is None:
            raise ValueError(
                "dict has neither a 'genome' nor a 'gemome' key"
            )
        if taxa is None:
            taxa = d.get("taxa")
    genome = np.asarray(genome, dtype=np.float64)
    if genome.ndim != 3:
        raise ValueError(
            f"genome must be one-hot (N, S, A); got shape {genome.shape}"
        )
    N = genome.shape[0]
    taxa = list(taxa) if taxa is not None else []
    if len(taxa) == 1 and isinstance(taxa[0], (list, tuple)):
        taxa = list(taxa[0])    # reference one-tuple wrapping
    if len(taxa) != N:
        # name-count mismatches inside the reference's own pickles
        # (betacorona1.p: 16 names, 17 genomes) fall back to generated
        # names; an EXPLICIT taxa argument that mismatches is a caller
        # bug and must not be silently discarded
        if user_taxa and taxa:
            raise ValueError(
                f"taxa has {len(taxa)} names for {N} genomes"
            )
        taxa = [f"S{i}" for i in range(N)]
    zero_rows = genome.sum(axis=-1) == 0
    if zero_rows.any():
        genome = genome.copy()
        genome[zero_rows] = 1.0
    return PhyloDataset(
        name=name, taxa=[str(t) for t in taxa], genome=genome
    )


def simulate_dna(n_taxa, seq_length, seed=0, alphabet=DNA_ALPHABET):
    """Random iid one-hot genomes (reference `simulateDNA`,
    runner.py:100-104) with a controllable seed."""
    rng = random.Random(seed)
    strings = [
        "".join(rng.choice(alphabet) for _ in range(seq_length))
        for _ in range(n_taxa)
    ]
    return dataset_from_strings(strings, name=f"simulated_{n_taxa}x{seq_length}")


def detect_alphabet(strings):
    """DNA unless the letters say otherwise.

    Frequency-based (the usual aligner heuristic): when >= 90% of the
    non-gap residues are A/C/G/T/U/N the alignment is nucleotide --
    robust to the odd unknown-base 'X' or stray code, which a strict
    subset test would silently reclassify as protein.  Anything
    dominated by amino-acid-only letters (E, F, I, L, P, Q, ...) is
    protein; the encoder still raises loudly on characters the chosen
    alphabet cannot represent.

    Guard rails (ADVICE r2): every nucleotide letter is also a standard
    amino acid, so a compositionally biased protein (rich in
    A/G/S/T/R/K/V...) could sneak past a pure frequency test.  Two
    checks close that hole: (a) a nucleotide-looking alignment that
    still carries > 5% amino-acid-only letters (E/F/I/L/P/Q/J/Z --
    leucine alone averages ~10% of real proteins) is treated as
    ambiguous, and (b) the 0.8-0.9 nucleotide-fraction band is
    ambiguous outright.  Ambiguous input raises with instructions to
    pass an explicit ``alphabet=``; the decision and both fractions
    are logged at INFO either way."""
    import logging

    from phylo_tpu_torch.dataio.alphabets import PROTEIN_ALPHABET

    import numpy as _np

    codes = _np.frombuffer(
        "".join(strings).upper().encode("latin-1"), dtype=_np.uint8
    )
    gap = _np.isin(codes, _np.frombuffer(b"-?. *", dtype=_np.uint8))
    residues = codes[~gap]
    if residues.size == 0:
        return DNA_ALPHABET
    # A/C/G/T/U/N plus the IUPAC ambiguity codes; amino-acid-only
    # letters (E, F, I, L, P, Q, ...) keep real proteins well under
    # the 90% threshold (~70% of a typical protein falls in this set)
    nuc_frac = _np.isin(
        residues, _np.frombuffer(b"ACGTUNRYSWKMBDHV", dtype=_np.uint8)
    ).mean()
    aa_only_frac = _np.isin(
        residues, _np.frombuffer(b"EFILPQJZ", dtype=_np.uint8)
    ).mean()
    log = logging.getLogger("phylo_tpu_torch.dataio")
    if nuc_frac >= 0.9 and aa_only_frac <= 0.05:
        choice = DNA_ALPHABET
    elif nuc_frac < 0.8:
        choice = PROTEIN_ALPHABET
    else:
        raise ValueError(
            "detect_alphabet: ambiguous alignment (nucleotide-letter "
            f"fraction {nuc_frac:.3f}, amino-acid-only fraction "
            f"{aa_only_frac:.3f}) -- a compositionally biased protein "
            "and a noisy DNA alignment are indistinguishable here; "
            "pass alphabet=DNA_ALPHABET or alphabet=PROTEIN_ALPHABET "
            "explicitly."
        )
    log.info(
        "detect_alphabet: %s (nucleotide fraction %.3f, "
        "amino-acid-only fraction %.3f)",
        "DNA" if choice == DNA_ALPHABET else "protein",
        nuc_frac, aa_only_frac,
    )
    return choice


def _taxa_dict_dataset(name, raw, alphabet=None):
    """Build a dataset from a {taxon: sequence-string} dict, preserving
    insertion order like the reference's list(dict.values()).

    alphabet: DNA_ALPHABET / PROTEIN_ALPHABET / any state string; None
    auto-detects (reference pickles are all DNA; parsed FASTA/PHYLIP/
    NEXUS files may be protein -- an extension, the reference is
    DNA-only)."""
    taxa = list(raw.keys())
    strings = list(raw.values())
    if alphabet is None:
        alphabet = detect_alphabet(strings)
    genome = encode_strings(strings, alphabet)
    return PhyloDataset(name=name, taxa=taxa, genome=genome)


def _load_hohna(root, idx):
    zpath = os.path.join(root, "hohna_dataset_pickle.zip")
    with zipfile.ZipFile(zpath) as z:
        raw = pickle.loads(z.read(f"DS{idx}.pickle"))
    return _taxa_dict_dataset(f"hohna_data_{idx}", raw)


def _load_onehot_dict(root, name, relpath):
    # dataset_from_arrays absorbs the reference pickle quirks: the
    # 'gemome' (sic) key of betacorona2.p, one-tuple-wrapped taxa, the
    # 16-names-for-17-genomes mismatch of betacorona1.p (generated
    # names), and spikeGP.p's all-zero observation rows (missing-data
    # all-ones, the '-'/'?' convention of runner.py:91-96 -- a zero row
    # would make the site likelihood exactly 0, log -> -inf).
    return dataset_from_arrays(
        _read_pickle(os.path.join(root, relpath)), name=name
    )


_MISSING = {
    "corona_data": "data/coronavirus.p is not shipped in the reference repo",
    "ginkgo": "data/gingko/test_data_14.p is not shipped in the reference repo",
}


def list_datasets():
    names = [
        "primate_data",
        "primate_data_wang",
        "fish_data",
        "betacorona1",
        "betacorona2",
        "spike_data",
        "load_strings",
        "simulate_data",
    ]
    names += [f"hohna_data_{i}" for i in range(1, 12)]
    names += ["hohna_data"]  # alias for DS1, reference runner.py:117
    return names


def load_dataset(name, data_root=None, **kwargs):
    """Load a dataset by its reference CLI flag name.

    `name` matches the reference's exec-based dataset flags
    (runner.py:61-195); a few aliases are accepted (e.g. 'primate' for
    'primate_data', 'DS3' for 'hohna_data_3').
    """
    root = data_root or DEFAULT_DATA_ROOT
    key = name.strip()
    # direct alignment files (FASTA / PHYLIP / NEXUS), a capability the
    # reference lacks (it only reads pre-pickled dicts)
    if os.path.sep in key or os.path.exists(key):
        from phylo_tpu_torch.dataio.parsers import load_alignment_file

        raw = load_alignment_file(key)
        return _taxa_dict_dataset(os.path.basename(key), raw,
                                  alphabet=kwargs.get("alphabet"))
    alias = {
        "primate": "primate_data",
        "primates_small": "primate_data_wang",
        "fish": "fish_data",
        "strings": "load_strings",
        "simulated": "simulate_data",
        "hohna_data": "hohna_data_1",
        "spikeGP": "spike_data",
    }
    key = alias.get(key, key)
    if key.upper().startswith("DS") and key[2:].isdigit():
        key = f"hohna_data_{int(key[2:])}"

    if key in _MISSING:
        raise FileNotFoundError(
            f"dataset {name!r}: {_MISSING[key]}; use another dataset or "
            "point data_root at a directory providing it"
        )
    if key == "primate_data":
        return _taxa_dict_dataset(
            "primate_data", _read_pickle(os.path.join(root, "primate.p"))
        )
    if key == "primate_data_wang":
        return _taxa_dict_dataset(
            "primate_data_wang",
            _read_pickle(os.path.join(root, "primates_small.p")),
        )
    if key == "fish_data":
        return _taxa_dict_dataset(
            "fish_data", _read_pickle(os.path.join(root, "fish.p"))
        )
    if key.startswith("hohna_data_"):
        return _load_hohna(root, int(key.rsplit("_", 1)[1]))
    if key == "betacorona1":
        return _load_onehot_dict(root, key, "betacoronavirus/betacorona1.p")
    if key == "betacorona2":
        return _load_onehot_dict(root, key, "betacoronavirus/betacorona2.p")
    if key == "spike_data":
        return _load_onehot_dict(root, key, "betacoronavirus/spikeGP.p")
    if key == "load_strings":
        return dataset_from_strings(
            kwargs.get("strings", REFERENCE_STRINGS), name="load_strings"
        )
    if key == "simulate_data":
        return simulate_dna(
            kwargs.get("n_taxa", 3),
            kwargs.get("seq_length", 5),
            seed=kwargs.get("seed", 0),
        )
    raise KeyError(f"unknown dataset {name!r}; known: {list_datasets()}")
