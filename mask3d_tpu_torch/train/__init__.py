"""The test entry: set criterion, checkpoint reader, exports and the trainer's
eval path."""
