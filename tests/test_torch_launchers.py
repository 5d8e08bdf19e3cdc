"""The port's launchers (``protosam_tpu_torch/run_protosam.sh``,
``backbone.sh``) issue the root scripts' commands: a fake ``python3`` first
on ``PATH`` records each script's argv, which must equal the root
script's apart from the module path."""

import json
import os
import pathlib
import subprocess

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FAKE = """#!/bin/sh
python - "$@" <<'PY'
import json, sys
with open("{out}", "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
PY
"""
MODULES = {"validation_protosam.py": "protosam_tpu_torch.validation_protosam",
           "training.py": "protosam_tpu_torch.training",
           "validation.py": "protosam_tpu_torch.validation"}


def _argv(tmp_path, script, args):
    """The argv the script gives python3, run from a fresh directory."""
    bin_dir, work = tmp_path / "bin", tmp_path / "work"
    bin_dir.mkdir(exist_ok=True)
    work.mkdir(exist_ok=True)
    out = tmp_path / "argv.jsonl"
    if out.exists():
        out.unlink()
    fake = bin_dir / "python3"
    fake.write_text(FAKE.format(out=out))
    fake.chmod(0o755)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MODEL_NAME", "INPUT_SIZE", "SEED", "LOGDIR")}
    env["PATH"] = f"{bin_dir}:{env['PATH']}"
    subprocess.run(["bash", str(script), *args], cwd=work, env=env,
                   check=True, capture_output=True, timeout=60)
    return [json.loads(line) for line in out.read_text().splitlines()]


@pytest.mark.parametrize("script,args", [
    ("run_protosam.sh", ["ct"]), ("run_protosam.sh", ["mri"]),
    ("run_protosam.sh", ["polyp"]),
    ("backbone.sh", ["training", "ct"]),
    ("backbone.sh", ["training", "mri", "1"]),
    ("backbone.sh", ["validation", "ct"]),
    ("backbone.sh", ["validation", "mri"])])
def test_port_launcher_issues_the_root_command(tmp_path, script, args):
    (root,) = _argv(tmp_path, ROOT / script, args)
    (port,) = _argv(tmp_path, ROOT / "protosam_tpu_torch" / script, args)
    assert root[0] in MODULES
    assert port == ["-m", MODULES[root[0]]] + root[1:]
    assert port[2] == "with" and len(port) > 5


@pytest.mark.parametrize("script,args", [("run_protosam.sh", ["pet"]),
                                         ("backbone.sh", ["training", "pet"])])
def test_port_launcher_refuses_as_the_root_one(tmp_path, script, args):
    for path in (ROOT / script, ROOT / "protosam_tpu_torch" / script):
        with pytest.raises(subprocess.CalledProcessError) as e:
            _argv(tmp_path, path, args)
        assert b"modality must be" in e.value.stdout
