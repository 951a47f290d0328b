"""Alignment file parsers: FASTA, relaxed PHYLIP, and NEXUS data blocks.

The reference only loads pre-pickled dicts (reference runner.py:117-195)
even though its data directory ships raw NEXUS/FASTA archives
(data/betacoronavirus/*.zip).  These parsers accept those formats
directly, producing the same {taxon: sequence} mapping the pickle
loaders yield.
"""

from __future__ import annotations

import re


def parse_fasta(text):
    """'>name\\nSEQ...' records -> ordered {name: sequence}."""
    seqs = {}
    name = None
    chunks = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                seqs[name] = "".join(chunks)
            name = line[1:].split()[0]
            chunks = []
        else:
            if name is None:
                raise ValueError("FASTA: sequence data before first '>'")
            chunks.append(line)
    if name is not None:
        seqs[name] = "".join(chunks)
    if not seqs:
        raise ValueError("FASTA: no records found")
    return seqs


def parse_phylip(text):
    """Relaxed PHYLIP: header 'ntaxa nsites', then 'name seq' lines
    (interleaved continuation lines are appended in round-robin)."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    header = lines[0].split()
    if len(header) < 2 or not header[0].isdigit():
        raise ValueError("PHYLIP: missing 'ntaxa nsites' header")
    n, s = int(header[0]), int(header[1])
    names, seqs = [], []
    for ln in lines[1:]:
        parts = ln.split(None, 1)
        if len(names) < n:
            if len(parts) != 2:
                raise ValueError(f"PHYLIP: bad taxon line {ln!r}")
            names.append(parts[0])
            seqs.append(re.sub(r"\s", "", parts[1]))
        else:
            # interleaved continuation: append to the shortest sequence
            idx = min(range(n), key=lambda j: len(seqs[j]))
            seqs[idx] += re.sub(r"\s", "", ln)
    out = dict(zip(names, seqs))
    for name, seq in out.items():
        if len(seq) != s:
            raise ValueError(
                f"PHYLIP: {name} has {len(seq)} sites, header says {s}"
            )
    return out


def parse_nexus(text):
    """NEXUS DATA/CHARACTERS block MATRIX -> {taxon: sequence}.

    Handles quoted taxon names, interleaved matrices, and comments in
    square brackets.  Enough for TreeBASE-style exports (the reference's
    data/betacoronavirus/Treebase.zip)."""
    no_comments = re.sub(r"\[[^\]]*\]", "", text)
    m = re.search(
        r"matrix(.*?);", no_comments, flags=re.IGNORECASE | re.DOTALL
    )
    if not m:
        raise ValueError("NEXUS: no MATRIX section found")
    body = m.group(1)
    seqs = {}
    order = []
    for ln in body.splitlines():
        ln = ln.strip()
        if not ln:
            continue
        qm = re.match(
            r"^(?:'([^']+)'|\"([^\"]+)\"|(\S+))\s+(.+)$", ln
        )
        if not qm:
            continue
        name = qm.group(1) or qm.group(2) or qm.group(3)
        # sequences may be split into whitespace-separated chunks on one
        # line (TreeBASE exports do this)
        seq = re.sub(r"\s", "", qm.group(4))
        if not re.fullmatch(r"[A-Za-z?\-.*]+", seq):
            continue
        if name not in seqs:
            seqs[name] = ""
            order.append(name)
        seqs[name] += seq
    if not seqs:
        raise ValueError("NEXUS: empty matrix")
    return {name: seqs[name] for name in order}


def load_alignment_file(path):
    """Sniff the format of an alignment file and parse it."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith(">"):
        return parse_fasta(text)
    if stripped[:6].lower() == "#nexus":
        return parse_nexus(text)
    return parse_phylip(text)
