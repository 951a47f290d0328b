from phylo_tpu_torch.dataio.alphabets import (  # noqa: F401
    DNA_ALPHABET,
    DNA_AMBIGUITY,
    PROTEIN_ALPHABET,
    encode_strings,
    one_hot_rows,
)
from phylo_tpu_torch.dataio.codons import (  # noqa: F401
    CODON_AA,
    SENSE_CODONS,
    codon_dataset,
    empirical_codon_frequencies,
    encode_codon_strings,
)
from phylo_tpu_torch.dataio.datasets import (  # noqa: F401
    PhyloDataset,
    dataset_from_arrays,
    dataset_from_strings,
    detect_alphabet,
    list_datasets,
    load_dataset,
    simulate_dna,
)
