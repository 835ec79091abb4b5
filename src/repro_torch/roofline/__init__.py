"""Three-term roofline over the dry run's records (``analysis``)."""
