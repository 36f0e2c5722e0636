"""Training data: a byte tokenizer and a restartable synthetic token pipeline."""
