"""Preprocessing (wav -> features and splits) and the training data pipeline."""
