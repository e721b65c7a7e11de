"""Signal processing: STFT, mel filterbank, feature extraction and
Griffin-Lim (torch on the device), wav I/O, resampling and f0 (numpy /
scipy on the host)."""
