"""Tools of the port that the CLI runs (``make_goldens``)."""
