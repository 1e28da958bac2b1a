"""Splice_tpu_torch.ipynb, the port's interactive notebook: its cells follow
Splice_tpu.ipynb's (the same ten cells in order, the same markdown where
the package is not named, the same hooks and the same show_result), its
code imports neither JAX nor the JAX package, no cell catches an error,
and it runs end to end through nbclient on the CPU at
tests/test_notebook.py's sizes with device='cpu' (the notebook's
OVERRIDES hook). On the card chip_smoke.py phase 15 runs its code cells
at full width.
"""
import pathlib
import re
import shutil

import nbformat
from nbclient import NotebookClient

ROOT = pathlib.Path(__file__).resolve().parent.parent
NB_PATH = ROOT / "Splice_tpu_torch.ipynb"
REF_PATH = ROOT / "Splice_tpu.ipynb"


def _show_result(source: str) -> str:
    return re.search(r"def show_result\(out\):\n(?:    .*\n)+", source).group(0)


def test_cells_follow_the_reference_notebook():
    nb = nbformat.read(str(NB_PATH), as_version=4)
    ref = nbformat.read(str(REF_PATH), as_version=4)
    assert [c.cell_type for c in nb.cells] == [c.cell_type for c in ref.cells]
    assert len(nb.cells) == 10
    # the pair, train and inspect sections' text is the reference's
    for i in (2, 6, 8):
        assert nb.cells[i].source == ref.cells[i].source
    assert "python -m splice_tpu_torch.tools.port_dino_weights" in \
        nb.cells[4].source
    assert "DATAROOT = 'datasets/splicing/cows'" in nb.cells[3].source
    assert nb.cells[3].source == ref.cells[3].source
    for hook in ("VIT_WEIGHTS = None", "N_STEPS = 2000", "OVERRIDES = {}"):
        assert hook in nb.cells[5].source
    assert _show_result(nb.cells[7].source) == \
        _show_result(ref.cells[7].source)
    assert "trainer.train_pair(cfg, callback=show_result)" in \
        nb.cells[7].source
    assert "from splice_tpu_torch import trainer" in nb.cells[7].source
    assert "from splice_tpu_torch.tools.keys_self_sim_pca import visualize" \
        in nb.cells[9].source
    code = "\n".join(c.source for c in nb.cells if c.cell_type == "code")
    assert not re.search(r"^\s*(import|from)\s+(jax|splice_tpu(\.|\s|$)|"
                         r"scripts)", code, re.M)
    assert not re.search(r"^\s*(try|except)\b", code, re.M)


def test_notebook_executes_end_to_end_on_cpu(tmp_path):
    src = ROOT / "datasets" / "splicing" / "cows"
    root = tmp_path / "pair"
    shutil.copytree(src / "A", root / "A")
    shutil.copytree(src / "B", root / "B")

    nb = nbformat.read(str(NB_PATH), as_version=4)
    assert "OVERRIDES" in nb.cells[5].source
    nb.cells[5].source = (
        "VIT_WEIGHTS = None\n"
        "N_STEPS = 4\n"
        "OVERRIDES = dict(A_resize=48, B_resize=48, seed=3,\n"
        "                 log_images_freq=2, entire_A_every=10,\n"
        "                 dino_model_name='dino_vits8',\n"
        "                 dino_global_patch_size=32,\n"
        "                 dino_global_max_size=64,\n"
        "                 use_pallas_attention=False,\n"
        "                 vit_compute_dtype='float32', device='cpu')\n")
    assert "datasets/splicing/cows" in nb.cells[3].source
    nb.cells[3].source = nb.cells[3].source.replace(
        "'datasets/splicing/cows'", repr(str(root)))
    # one intra-op thread in the kernel, as the other heavy torch tests run
    nb.cells.insert(0, nbformat.v4.new_code_cell(
        "import torch\ntorch.set_num_threads(1)\n"))
    for i, c in enumerate(nb.cells):
        c.id = f"cell-{i}"

    # a cell's limit: the whole notebook takes 20-40 s on a loaded host
    client = NotebookClient(nb, timeout=240, kernel_name="python3",
                            resources={"metadata": {"path": str(ROOT)}})
    client.execute()

    assert (root / "out" / "output.png").exists()
    assert (root / "out" / "structure_pca.png").exists()
    printed = "".join(o.get("text", "") for o in nb.cells[8].outputs)
    assert "steps/s" in printed
