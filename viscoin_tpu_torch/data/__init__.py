"""Host transforms and the on-device preprocess."""
