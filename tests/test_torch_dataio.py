"""The port's data loaders (phylo_tpu_torch.dataio, a NumPy copy) give
byte-equal encodings to phylo_tpu.dataio."""

import numpy as np
import pytest
import torch

from phylo_tpu import dataio as jax_dataio
from phylo_tpu_torch import dataio as torch_dataio

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["primate", "primates_small",
                                  "betacorona1", "spike_data",
                                  "hohna_data_1", "load_strings"])
def test_datasets_byte_equal(name):
    want = jax_dataio.load_dataset(name)
    got = torch_dataio.load_dataset(name)
    assert got.name == want.name
    assert list(got.taxa) == list(want.taxa)
    assert got.genome.dtype == want.genome.dtype
    assert got.genome.shape == want.genome.shape
    assert got.genome.tobytes() == want.genome.tobytes()


def test_spike_is_seven_states():
    assert torch_dataio.load_dataset("spike_data").A == 7


@pytest.mark.parametrize("strings", [
    ["ACGT-?NR", "acgtYKMs"],
    ["ACDEFGHIKLMNPQRSTVWY"],
])
def test_encode_strings_byte_equal(strings):
    alphabet = (torch_dataio.PROTEIN_ALPHABET if len(strings) == 1
                else torch_dataio.DNA_ALPHABET)
    got = torch_dataio.encode_strings(strings, alphabet)
    want = jax_dataio.encode_strings(strings, alphabet)
    assert np.array_equal(got, want) and got.dtype == want.dtype


def test_unknown_dataset_lists_options():
    with pytest.raises(KeyError, match="known"):
        torch_dataio.load_dataset("no_such_dataset")
