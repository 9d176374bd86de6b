"""Signal-processing front end of the port: ``ops.mel`` (STFT, mel filterbank,
log compression, on the device) and ``ops.resample`` (host-side resampler)."""
