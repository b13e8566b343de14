"""The ``config`` questionnaire, ``config update`` and the cursor menu
against the JAX package's (``accelerate_tpu/commands/config/config.py``,
``update.py``, ``commands/menu.py``).

The same scripted answers go through both packages' ``get_user_input``
(``input`` monkeypatched; pytest's stdin is not a TTY, so the menus ask
numbered prompts) and must give the same fields, except those the JAX
package has for TPUs: ``compute_environment``'s ``TPU_POD`` is the port's
``MULTI_MACHINE``; ``tpu_name`` and ``tpu_zone`` (gcloud) are not asked
here; ``emulated_device_count`` is not asked by either and defaults to
the process model's (8 emulated devices there, 1 process here).
"""

import builtins

import pytest
import yaml

#: Fields excepted from the comparison, and why.
TPU_ONLY = {"tpu_name": "gcloud orchestration of TPU pods",
            "tpu_zone": "gcloud orchestration of TPU pods",
            "emulated_device_count": "emulated TPU devices; the port emulates processes"}
ENVIRONMENT = {"TPU_POD": "MULTI_MACHINE", "LOCAL_MACHINE": "LOCAL_MACHINE"}

#: Scripted answers: (the JAX package's, the port's). The port asks
#: neither the TPU name nor its zone.
SCRIPTS = {
    "defaults": ([""] * 9, [""] * 9),
    "one_machine": (["1", "3", "-1", "2", "2", "1", "1", "2", "1"],
                    ["1", "3", "-1", "2", "2", "1", "1", "2", "1"]),
    "machines": (["2", "2", "10.1.2.3", "9000", "1", "my-pod", "us-central2-b", "2", "1", "4",
                  "1", "2", "1", "1", "no-such-choice"],
                 ["2", "2", "10.1.2.3", "9000", "1", "2", "1", "4", "1", "2", "1", "1",
                  "no-such-choice"]),
    "names_and_bad_numbers": (["TPU_POD", "1", "", "", "fp16", "x", "1", "1", "1", "1", "1",
                               "yes"],
                              ["MULTI_MACHINE", "1", "fp16", "x", "1", "1", "1", "1", "1",
                               "yes"]),
}


def _answers(monkeypatch, answers):
    it = iter(answers)
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(it))
    return it


def _comparable(fields: dict) -> dict:
    out = {k: v for k, v in fields.items() if k not in TPU_ONLY}
    out["compute_environment"] = ENVIRONMENT.get(out["compute_environment"],
                                                 out["compute_environment"])
    return out


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_questionnaire_writes_what_the_jax_questionnaire_writes(monkeypatch, script):
    from accelerate_tpu.commands.config.config import get_user_input as jax_input
    from accelerate_tpu_torch.commands.config.config import get_user_input

    jax_answers, port_answers = SCRIPTS[script]
    left = _answers(monkeypatch, jax_answers)
    want = jax_input().to_dict()
    assert next(left, None) is None, "the JAX questionnaire left answers unread"
    left = _answers(monkeypatch, port_answers)
    got = get_user_input().to_dict()
    assert next(left, None) is None, "the questionnaire left answers unread"
    assert _comparable(got) == _comparable(want)
    assert set(got) | set(TPU_ONLY) >= set(want)


def test_bare_config_runs_the_questionnaire_and_the_jax_package_reads_the_file(
        tmp_path, monkeypatch, capsys):
    from accelerate_tpu.commands.config.config_args import load_config_from_file as jax_load
    from accelerate_tpu_torch.commands import accelerate_cli

    path = tmp_path / "asked.yaml"
    _answers(monkeypatch, SCRIPTS["one_machine"][1])
    monkeypatch.setattr("sys.argv", ["accelerate-tpu-torch", "config", "--config_file",
                                     str(path)])
    assert accelerate_cli.main() == 0
    assert "Mixed precision" in capsys.readouterr().out
    cfg = jax_load(str(path))
    assert (cfg.mixed_precision, cfg.mesh_fsdp, cfg.mesh_tp, cfg.mesh_ep, cfg.debug) == \
        ("fp16", 2, 2, 2, True)
    # --default and the default subcommand skip the questions.
    for argv in (["--default"], ["default"]):
        out = tmp_path / f"{argv[0].strip('-')}.yaml"
        monkeypatch.setattr("sys.argv", ["accelerate-tpu-torch", "config", *argv,
                                         "--config_file", str(out)])
        assert accelerate_cli.main() == 0
        assert jax_load(str(out)).mixed_precision == "bf16"


@pytest.mark.parametrize("written", ["jax_file", "unknown_keys", "hf_accelerate"])
def test_config_update_of_a_jax_file_equals_the_jax_update(tmp_path, monkeypatch, capsys,
                                                           written):
    import argparse

    from accelerate_tpu.commands.config.config_args import ClusterConfig as JaxConfig
    from accelerate_tpu.commands.config.update import update_config as jax_update
    from accelerate_tpu_torch.commands import accelerate_cli

    source = tmp_path / "source.yaml"
    if written == "hf_accelerate":
        source.write_text(yaml.safe_dump({
            "compute_environment": "LOCAL_MACHINE", "distributed_type": "FSDP",
            "mixed_precision": "bf16", "num_processes": 8, "use_cpu": True,
            "megatron_lm_config": {"megatron_lm_tp_degree": 2}}))
    else:
        JaxConfig(mixed_precision="fp16", mesh_tp=2, compute_environment="TPU_POD",
                  tpu_name="pod", num_machines=2, main_process_ip="10.0.0.2").save(str(source))
        if written == "unknown_keys":
            source.write_text(source.read_text() + "retired_option: 3\n")
    theirs, ours = tmp_path / "jax.yaml", tmp_path / "port.yaml"
    theirs.write_text(source.read_text())
    ours.write_text(source.read_text())
    jax_update(argparse.Namespace(config_file=str(theirs)))
    jax_out = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["accelerate-tpu-torch", "config", "update",
                                     "--config_file", str(ours)])
    assert accelerate_cli.main() == 0
    out = capsys.readouterr().out
    # A file without some fields (Hugging Face Accelerate's) takes each
    # package's defaults for them; the TPU-only ones differ there.
    assert _comparable(yaml.safe_load(ours.read_text())) == \
        _comparable(yaml.safe_load(theirs.read_text()))
    assert ("Dropping unknown keys" in out) == ("Dropping unknown keys" in jax_out)
    monkeypatch.setattr("sys.argv", ["accelerate-tpu-torch", "config", "update",
                                     "--config_file", str(tmp_path / "missing.yaml")])
    assert accelerate_cli.main() == 2


@pytest.mark.parametrize("keys", [
    ["\x1b[B", "\x1b[B", "\r"], ["j", "k", "k", "\n"], ["3", "\r"], ["q"], ["\x1b"],
    ["\x03"], ["x", "9", "j", "\r"], ["\x1b[A", "\r"],
])
def test_menu_keys_and_cursor_moves_equal_the_jax_menu(keys):
    from accelerate_tpu.commands import menu as jax_menu
    from accelerate_tpu_torch.commands import menu

    ours, theirs = menu.MenuState(n=4, pos=1), jax_menu.MenuState(n=4, pos=1)
    for key in keys:
        assert menu.decode_key(key) == jax_menu.decode_key(key)
        ours = menu.step_state(ours, menu.decode_key(key))
        theirs = jax_menu.step_state(theirs, jax_menu.decode_key(key))
        assert (ours.pos, ours.done, ours.cancelled) == \
            (theirs.pos, theirs.done, theirs.cancelled)


@pytest.mark.parametrize("answer", ["", "2", "c", "0", "7", "bf16"])
def test_numbered_prompt_picks_what_the_jax_prompt_picks(monkeypatch, answer):
    from accelerate_tpu.commands import menu as jax_menu
    from accelerate_tpu_torch.commands import menu

    choices = ["a", "b", "c"]
    _answers(monkeypatch, [answer, answer])
    assert menu.select("pick", choices, default="b") == \
        jax_menu.select("pick", choices, default="b")
