"""Host utilities: the split-timer (`meter`)."""
