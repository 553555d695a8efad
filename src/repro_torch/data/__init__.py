"""Tasks with verifiers, the byte tokenizer the reflection loop uses, and
the training data (``lm_data.py``); copies of ``repro/data``'s
counterparts."""
