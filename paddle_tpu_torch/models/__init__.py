"""Models of the port: ``transformer`` (the decoder-only LM of the serving
path and Transformer-base training), ``stacked_dynamic_lstm`` (the stacked
LSTM classifier's training) and ``convert`` (JAX scope weights into
them)."""
