"""Launch helpers: the one-device mesh the training loop runs under."""
