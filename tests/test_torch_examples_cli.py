"""The port's examples CLI (snark_bn254_verifier_tpu_torch/examples.py), the
counterpart of tests/test_examples_cli.py: the synthetic flow hands the
Groth16 vector and the device to the facade and prints its answer, and the
golden flows report where the binaries are missing. The facade itself is
tested in tests/test_torch_facades.py; here it is replaced by a recorder,
so the CLI test runs no pipeline."""

from snark_bn254_verifier_tpu.fixtures.gen import gen_groth16_vector
from snark_bn254_verifier_tpu_torch import Groth16Verifier, examples


def test_synthetic_groth16_on_cpu(monkeypatch, capsys):
    calls = []

    class Recorder:
        @staticmethod
        def verify(proof, vk, public_inputs, device):
            calls.append((proof, vk, list(public_inputs), device))
            return True

    chosen = []
    monkeypatch.setattr(examples, "_verifier", lambda mode: chosen.append(mode) or Recorder)
    assert examples.main(["--synthetic", "--mode", "groth16", "--device", "cpu"]) == 0
    vec = gen_groth16_vector(0)
    assert chosen == ["groth16"]
    assert calls == [(vec.proof, vec.vk, list(vec.public_inputs), "cpu")]
    assert "synthetic groth16 verify: True" in capsys.readouterr().out
    monkeypatch.undo()
    assert examples._verifier("groth16") is Groth16Verifier


def test_device_defaults_to_cuda(monkeypatch):
    devices = []

    class Recorder:
        @staticmethod
        def verify(proof, vk, public_inputs, device):
            devices.append(device)
            return True

    monkeypatch.setattr(examples, "_verifier", lambda mode: Recorder)
    assert examples.main(["--synthetic", "--mode", "plonk"]) == 0
    assert devices == ["cuda"]


def test_golden_flows_report_missing_binaries(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(examples, "GOLDEN_DIR", str(tmp_path))
    assert examples.main(["--golden", "--elf", "sha2", "--mode", "plonk", "--device", "cpu"]) == 1
    assert examples.main(["--all-golden", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert out.count("golden vector not found") == 1 + 2 * len(examples.ELFS)
