"""One driver per kind of traffic; a mix names its driver by file name."""
