"""One generator per kind of traffic; a traffic file names its driver."""
