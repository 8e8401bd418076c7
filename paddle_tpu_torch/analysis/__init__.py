"""Program analysis of the port (counterpart of ``paddle_tpu/analysis``):
for now only the serving geometry record of ``contracts.py``. The
per-program verifier and the family verifier are ROADMAP A6.10."""
