"""utils/torch_convert.py of the port against the JAX package's conversion.

A synthesised torchvision ResNet-50 and ``maskrcnn_resnet50_fpn`` state dict
(made by the functions of tests/test_convert.py) loaded by the port must
equal, tensor for tensor, the JAX ``convert_resnet50`` / ``convert_maskrcnn``
trees carried over by ``state_dict_from_jax``: both packages then compute the
same function from one checkpoint. Heads of another size keep their fresh initialisation;
any other shape mismatch raises.
"""
import copy

import pytest
import torch

from meshrcnn_tpu.utils.torch_convert import convert_maskrcnn, convert_resnet50
from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
from meshrcnn_tpu_torch.utils.jax_params import state_dict_from_jax
from meshrcnn_tpu_torch.utils.torch_convert import load_backbone
from tests.test_convert import build_torch_style_maskrcnn_sd, build_torch_style_state_dict


def _via_jax(model, params, stats):
    """``model`` with the JAX trees merged in under ``backbone``, as
    ``merge_backbone_params`` grafts them."""
    out = copy.deepcopy(model)
    sd = state_dict_from_jax(out, {"backbone": params}, {"backbone": stats})
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    out.load_state_dict(sd, strict=False)
    return out


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _shapenet():
    torch.manual_seed(0)
    return ShapeNetModel(num_classes=13, vertex_feature_dim=8, num_refinement_stages=1,
                         voxel_out_channels=8)


def _pix3d():
    torch.manual_seed(0)
    return Pix3DModel(num_classes=10, vertex_feature_dim=8, num_refinement_stages=1,
                      backbone_dtype="float32")


@pytest.mark.parametrize("num_classes", [1000, 13])
def test_resnet50_matches_jax_conversion(tmp_path, num_classes):
    sd = build_torch_style_state_dict(num_classes=num_classes)
    fresh = _shapenet()
    path = tmp_path / "resnet50.pth"
    torch.save(sd, path)
    got = copy.deepcopy(fresh)
    loaded, skipped = load_backbone(got, str(path), maskrcnn=False)
    want = _via_jax(fresh, *convert_resnet50(sd, num_classes=13))
    _assert_same_state(got, want)
    # the ImageNet head keeps its fresh initialisation, a 13-way head loads
    head = got.backbone.fc.weight
    assert torch.equal(head, fresh.backbone.fc.weight) == (num_classes == 1000)
    assert skipped == (2 if num_classes == 1000 else 0)
    assert torch.equal(got.backbone.layer3_2.conv2.weight, sd["layer3.2.conv2.weight"])


@pytest.mark.parametrize("num_classes,pool", [(91, 12), (10, 12), (91, 7)])
def test_maskrcnn_matches_jax_conversion(tmp_path, num_classes, pool):
    sd = build_torch_style_maskrcnn_sd(num_classes=num_classes)
    if pool != 12:    # a COCO box head: 7x7 pooled features
        sd["roi_heads.box_head.fc6.weight"] = torch.randn(1024, pool * pool * 256) * 0.01
    fresh = _pix3d()
    path = tmp_path / "maskrcnn.pth"
    torch.save(sd, path)
    got = copy.deepcopy(fresh)
    load_backbone(got, str(path), maskrcnn=True)
    want = _via_jax(fresh, *convert_maskrcnn(sd, num_classes=10))
    _assert_same_state(got, want)
    heads = got.backbone.roi_heads
    assert torch.equal(heads.box_predictor.cls_score.weight,
                       fresh.backbone.roi_heads.box_predictor.cls_score.weight) == (
        num_classes != 10)
    # fc6 and fc7 are swapped together for another pool size
    assert torch.equal(heads.box_head.fc7.weight,
                       fresh.backbone.roi_heads.box_head.fc7.weight) == (pool != 12)


def test_other_shape_mismatch_raises_and_port_checkpoint_loads(tmp_path):
    sd = build_torch_style_state_dict()
    sd["layer1.0.conv2.weight"] = torch.zeros(64, 64, 5, 5)
    path = tmp_path / "bad.pth"
    torch.save(sd, path)
    with pytest.raises(ValueError, match="layer1_0.conv2"):
        load_backbone(_shapenet(), str(path), maskrcnn=False)
    # a checkpoint of the port's own save_state: its backbone entries load
    src = _shapenet()
    with torch.no_grad():
        for p in src.parameters():
            p.add_(1.0)
    ckpt = tmp_path / "model_0.pt"
    torch.save({"model": src.state_dict(), "settings": {}}, ckpt)
    dst = _shapenet()
    loaded, skipped = load_backbone(dst, str(ckpt), maskrcnn=False)
    assert skipped == 0 and loaded == sum(1 for k in src.state_dict() if k.startswith("backbone."))
    assert torch.equal(dst.backbone.conv1.weight, src.backbone.conv1.weight)
    assert not torch.equal(dst.voxelBranch.conv0.weight, src.voxelBranch.conv0.weight)
