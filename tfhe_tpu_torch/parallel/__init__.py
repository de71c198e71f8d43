"""Multi-device execution: the ciphertext batch split over the CUDA devices
of a host (:mod:`.mesh`)."""
