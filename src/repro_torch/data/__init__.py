from repro_torch.data.pipeline import TokenDataset, DataIterator  # noqa: F401
