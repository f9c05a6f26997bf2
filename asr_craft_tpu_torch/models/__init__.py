"""CRF model pieces: topology, feature map, weight files, the model."""
