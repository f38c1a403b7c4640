"""Training and the test entry: the train step with AdamW (`loop`), the set
criterion, checkpoints, the metric logger, exports and the trainer."""
