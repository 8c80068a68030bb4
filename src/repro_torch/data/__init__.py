"""Synthetic datasets, the vertical split and LM token streams (numpy
copies of ``repro.data``'s generators: the same seed gives the same
arrays)."""
from repro_torch.data.synthetic import (classification_dataset,
                                        paper_datasets, regression_dataset)
from repro_torch.data.tokens import TokenStream, synthetic_token_batches
from repro_torch.data.vertical import vertical_split

__all__ = ["TokenStream", "classification_dataset", "paper_datasets",
           "regression_dataset", "synthetic_token_batches", "vertical_split"]
