"""The host-side data pipeline, kept in the port as copies of
``groma_tpu/data`` (numpy only, no JAX): tokenization, conversation
templates, tokenizers, the image pipeline (PIL and cv2 imported where used),
datasets, the source-grouped sampler, ``collate_vl`` and the threaded
loader."""
