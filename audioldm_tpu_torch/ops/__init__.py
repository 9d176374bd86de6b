"""Signal-processing front end of the port: ``ops.mel`` (STFT, mel filterbank,
log compression, on the device), ``ops.resample`` (the polyphase resampler,
on the device and on the host) and ``ops.kaldi`` (Kaldi filterbank
features, host numpy)."""
