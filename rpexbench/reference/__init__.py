"""Plain PyTorch references, one module per model family, named by a
configuration's ``reference`` key.  They import nothing of the program and
take only what the benchmark draws: weights, batches and token ids."""
