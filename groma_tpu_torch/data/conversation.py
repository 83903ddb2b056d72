"""Conversation templating (reference: groma/data/conversation.py:6-110).

Four separator styles with the exact prompt strings the released Groma
checkpoints were trained on — prompt-format parity is accuracy-critical
for REC/caption eval.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class Conversation:
    system: str
    roles: Tuple[str, str]
    sep_style: str
    sep: str = '###'
    sep2: Optional[str] = None

    def get_prompt(self, messages: Sequence) -> str:
        if self.sep_style == 'single':
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + ': ' + message + self.sep
                else:
                    ret += role + ':'
            return ret
        if self.sep_style == 'two':
            seps = [self.sep, self.sep2]
            ret = self.system + self.sep
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + ': ' + message + seps[i % 2]
                else:
                    ret += role + ':'
            return ret
        if self.sep_style == 'plain':
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, message in enumerate(messages):
                ret += message + seps[i % 2]
            return ret
        if self.sep_style == 'llama2':
            def wrap_sys(msg):
                return f'<<SYS>>\n{msg}\n<</SYS>>\n\n'

            def wrap_inst(msg):
                return f'[INST] {msg} [/INST]'

            ret = ''
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message and role == self.roles[0]
                if message:
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        ret += self.sep + wrap_inst(message)
                    else:
                        ret += ' ' + message + ' ' + self.sep2
            return ret.lstrip(self.sep)
        raise ValueError(f'Invalid style: {self.sep_style}')


conv_plain = Conversation(system='', roles=('', ''), sep_style='plain',
                          sep=' ', sep2='')

_VICUNA_SYSTEM = (
    'A chat between a curious user and an artificial intelligence '
    'assistant. The assistant gives helpful, detailed, and polite answers '
    "to the user's questions.")

conv_default = Conversation(system=_VICUNA_SYSTEM, roles=('USER', 'ASSISTANT'),
                            sep_style='two', sep=' ', sep2=' ')

conv_llava = Conversation(system=_VICUNA_SYSTEM, roles=('USER', 'ASSISTANT'),
                          sep_style='two', sep=' ', sep2='</s>')

conv_llama_2 = Conversation(
    system='You are a helpful language and vision assistant. '
           'You are able to understand the visual content that the user '
           'provides, and assist the user with a variety of tasks using '
           'natural language.',
    roles=('USER', 'ASSISTANT'), sep_style='llama2', sep='<s>', sep2='</s>')

conv_templates = {
    'simple': conv_plain,
    'default': conv_default,
    'llava': conv_llava,
    'llama_2': conv_llama_2,
}
