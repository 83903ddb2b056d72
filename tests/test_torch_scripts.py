"""The port's recipe launchers (``groma_tpu_torch/scripts/*.sh``) against
the JAX package's (``scripts/*.sh``).

Each launcher's command line is read from the script: the module after
``python -m`` and the arguments after it up to the pipe, with the line
continuations joined, a ``${VAR:+...}`` expansion taken as set and each
shell variable read as its default (``LIMIT=${3:-0}``) or its name.  The
port's arguments equal JAX's, apart from the module (``groma_tpu.`` ->
``groma_tpu_torch.``) and the dataset config paths
(``groma_tpu/data/configs/`` -> ``groma_tpu_torch/data/configs/``); the
port module's ``parse_args`` accepts them; JAX's scripts are as they were
(their SHA-256).
"""

import hashlib
import importlib
import os
import re
import shlex

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ('det_pretrain', 'vl_pretrain', 'vl_finetune', 'debug',
           'run_rec_eval', 'run_cap_eval', 'run_lvis_eval')
JAX_SHA256 = {
    'debug':
        'ff5a629d9677a90c7aa8759f3ab6ddc65696b908c9e92045623184e22a9189d1',
    'det_pretrain':
        '6c3ab64d72a7aeb03e198d5a35f538ad20ba607d886b81c4f18b94dd25471604',
    'run_cap_eval':
        '3b7f66ab24233d1a62e97ecaa5300d70187a11e5721a8e49130d0edbabc481d2',
    'run_lvis_eval':
        '79f8fc74342d5941a62f3cace5aa80abff0efb0ee55e585d095d415720891f4c',
    'run_rec_eval':
        'a72d121e0f76081e5244031eb69efe6ba007d18af4c293b49488627667f1d344',
    'vl_finetune':
        '4990727dc7fe2ec7cad4b44360765fd6a6ca8e2332cfa6150a2ba161376b52bb',
    'vl_pretrain':
        '23873a633b396d668b53074272ca2eaa63a47dadb34133cbf421d306e2befa68',
}


def _command(path: str):
    """-> (module, arguments) of the script's ``python -m`` command."""
    with open(path) as f:
        text = f.read().replace('\\\n', ' ')
    line = next(ln for ln in text.splitlines()
                if re.search(r'python -m \S+', ln))
    # a positional's default (LIMIT=${3:-0}) stands for it
    defaults = dict(re.findall(r'^(\w+)=\$\{\d+:-([^}]*)\}', text, re.M))
    line = re.sub(r'\$\{\w+:\+([^}]*)\}', r'\1', line)
    line = re.sub(r'\$\{?(\w+)[^}\s"]*\}?',
                  lambda m: defaults.get(m.group(1), m.group(1)), line)
    words = shlex.split(line.split(' | ')[0])
    at = words.index('-m')
    return words[at + 1], words[at + 2:]


def _as_port(word: str) -> str:
    return word.replace('groma_tpu/data/configs/',
                        'groma_tpu_torch/data/configs/')


@pytest.mark.parametrize('name', SCRIPTS)
def test_launcher_flags_equal_jax(name):
    jax_module, jax_args = _command(os.path.join(ROOT, 'scripts',
                                                 f'{name}.sh'))
    module, args = _command(os.path.join(ROOT, 'groma_tpu_torch', 'scripts',
                                         f'{name}.sh'))
    assert jax_module.startswith('groma_tpu.')
    assert module == 'groma_tpu_torch.' + jax_module[len('groma_tpu.'):]
    assert args == [_as_port(a) for a in jax_args]
    assert any(a.startswith('--') for a in args)
    for a in args:
        if a.endswith('.py'):
            assert a.startswith('groma_tpu_torch/data/configs/')
            assert os.path.isfile(os.path.join(ROOT, a)), a


@pytest.mark.parametrize('name', SCRIPTS)
def test_launcher_flags_parse(name):
    module, args = _command(os.path.join(ROOT, 'groma_tpu_torch', 'scripts',
                                         f'{name}.sh'))
    parsed = importlib.import_module(module).parse_args(args)
    given = {a[2:].replace('-', '_') for a in args if a.startswith('--')}
    assert given <= set(vars(parsed))
    assert parsed.device == 'cuda'


@pytest.mark.parametrize('name', SCRIPTS)
def test_jax_scripts_are_unchanged(name):
    with open(os.path.join(ROOT, 'scripts', f'{name}.sh'), 'rb') as f:
        assert hashlib.sha256(f.read()).hexdigest() == JAX_SHA256[name]
    assert os.access(os.path.join(ROOT, 'groma_tpu_torch', 'scripts',
                                  f'{name}.sh'), os.X_OK)
