"""Synthetic datasets and the vertical split (numpy copies of
``repro.data``'s generators: the same seed gives the same arrays)."""
from repro_torch.data.synthetic import (classification_dataset,
                                        paper_datasets, regression_dataset)
from repro_torch.data.vertical import vertical_split

__all__ = ["classification_dataset", "paper_datasets", "regression_dataset",
           "vertical_split"]
