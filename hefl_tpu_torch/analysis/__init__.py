"""Parameter-level integer certificates (closed form), counterpart of
`hefl_tpu.analysis`'s range certificates."""
