"""The port's family examples (``examples/{resnet_imagenet,mnist_spark,
unet_segmentation}.py``) and chip_smoke's phase families, on the CPU.

The phase's rehearsal trains tiny BERT, ViT and U-Net configs through the
zoo, holds BERT's and ViT's flash route (the kernels' plain versions here)
to the plain attention, and runs each of the three examples through the
port's ``tfcluster.run`` on one CPU node: the ResNet example on a gloo mesh
with a checkpoint, MNIST in ``InputMode.SPARK`` with the driver pushing
partitions through ``cluster.train`` and the chief's export, U-Net with its
mIoU and export. No kernel launches on the CPU.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from tensorflowonspark_tpu_torch.examples import mnist_spark, resnet_imagenet, unet_segmentation

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return __import__("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


def test_chip_smoke_families_phase_rehearses_on_cpu(capsys):
    """Every check of (a)-(d) passes at tiny sizes, the examples' lines
    and exports are there, and no kernel is launched."""
    from tensorflowonspark_tpu_torch.ops import bn_kernels
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    smoke = _chip_smoke()
    launches = smoke.phase_families(fa, bn_kernels, rehearse={
        "device": "cpu", "tiny": True, "sizes": {
            "bert_batch": 3, "bert_seq": 32, "bert_min_len": 8, "steps": 2, "mlm_batch": 2,
            "mlm_seq": 16, "vit_batch": 2, "unet_batch": 2, "unet_size": 18,
            "example_wait_s": 300, "resnet_args": ["--steps", "2", "--batch-size", "4"],
            "mnist_args": ["--num-records", "256", "--batch-size", "64"],
            "unet_args": ["--steps", "2", "--batch-size", "2", "--size", "18"]}})
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    check = lines[-1]
    assert check["case"] == "families_checks" and check["ok"], check
    assert sorted(check["checks"]) == ["a_bert", "a_mlm", "b_vit", "c_unet", "d_mnist",
                                       "d_resnet", "d_unet"]
    assert check["err"]["a_bert"]["lengths"][0] == 32 and min(
        check["err"]["a_bert"]["lengths"]) < 32
    assert "4 steps," in check["err"]["d_mnist"]["line"]
    assert check["err"]["d_resnet"]["saved_steps"] == [3]
    assert lines[-2]["part"] == "numbers"
    assert launches == {"fwd": 0, "dq": 0, "dkv": 0, "pair": 0, "cross": 0}


def test_examples_refuse_what_is_not_ported():
    args = resnet_imagenet.parse_args(["--cpu", "--tfrecords", "/data"])
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        resnet_imagenet.refuse_unported(args)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        resnet_imagenet.refuse_unported(resnet_imagenet.parse_args(["--max-restarts", "1"]))
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        mnist_spark.records(mnist_spark.parse_args(["--tfrecords", "/data"]))
    assert resnet_imagenet.parse_args([]).device is None
    assert unet_segmentation.parse_args(["--cpu"]).device == "cpu"


def test_mnist_records_and_rendered_masks():
    """The MNIST driver's records are (784 pixel ints, label) from
    ``default_rng(0)``, as the JAX example's; the U-Net example's rendered
    masks hold the three classes where the images hold the disk."""
    import numpy as np

    recs = mnist_spark.records(mnist_spark.parse_args(["--num-records", "3"]))
    rng = np.random.default_rng(0)
    for pixels, label in recs:
        assert np.array_equal(pixels, rng.integers(0, 255, size=784))
        assert label == int(rng.integers(0, 10))
    images, masks = unet_segmentation.render_circles(np.random.default_rng(0), 2, 32)
    assert images.shape == (2, 32, 32, 3) and masks.shape == (2, 32, 32)
    assert set(np.unique(masks)) == {0, 1, 2}
    assert torch.from_numpy(images).isfinite().all()
