"""Tasks with verifiers and the byte tokenizer the reflection loop uses;
copies of ``repro/data``'s counterparts (the training data, ``lm_data.py``,
is not ported)."""
