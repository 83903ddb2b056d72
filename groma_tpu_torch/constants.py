"""Special-token protocol shared by data, model and eval layers.

Capability parity with the reference token protocol (reference:
groma/constants.py:1-25): 17 named special tokens plus 100 region-index
tokens ``<r0>``..``<r99>``.  The LLM never emits boxes directly; it names
regions by index token, which maps back into the proposal pool.
"""

IGNORE_INDEX = -100

# Serving liveness protocol (reference: groma/constants.py:1-2).
CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15

DEFAULT_TOKENS = {
    'pad': "[PAD]",
    'bos': "<s>",
    'eos': "</s>",
    'unk': "<unk>",
    'sep': "<sep>",
    'boi': "<img>",
    'eoi': "</img>",
    'bor': "<roi>",
    'eor': "</roi>",
    'boe': "<p>",
    'eoe': "</p>",
    'image': "<image>",
    'region': "<region>",
    'rbox': "<refer_box>",
    'gbox': "<ground_box>",
    'rfeat': "<refer_feat>",
    'ground': "[grounding]",
}

NUM_REGION_TOKENS = 100
REGION_IDX_TOKENS = ['<r{}>'.format(i) for i in range(NUM_REGION_TOKENS)]

# Tokens appended to the base LLM vocabulary via add_tokens, in order.
# bos/eos/unk already exist in the LLaMA vocab so add_tokens skips them
# (reference: groma/train/train.py:90 => num_new_token == 114 for Vicuna).
EXISTING_IN_BASE = ('bos', 'eos', 'unk')
NEW_TOKENS = [v for k, v in DEFAULT_TOKENS.items()
              if k not in EXISTING_IN_BASE] + REGION_IDX_TOKENS
ALL_PROTOCOL_TOKENS = list(DEFAULT_TOKENS.values()) + REGION_IDX_TOKENS
