"""The LM substrate's models (PyTorch port of ``repro.models``): the dense
GQA transformer so far."""
