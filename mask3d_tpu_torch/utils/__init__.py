"""Host utilities: the split-timer (`meter`), k-fold scene splits
(`kfold`) and debug plots and gradient-flow statistics (`visualize`)."""
