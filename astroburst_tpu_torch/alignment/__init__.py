"""Phase-correlation alignment and its coarse box-mean kernel."""
