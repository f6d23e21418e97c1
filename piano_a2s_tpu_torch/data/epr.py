"""virtuosoNet EPR (expressive performance rendering) adapter.

A copy of piano_a2s_tpu/data/epr.py for the port.

The reference renders pretrain MIDI with virtuosoNet's
``load_file_and_generate_performance`` — composer-conditioned, latent
z=0 (reference: data_processing/render.py:395-455: it chdirs into a
``virtuosoNet`` checkout, copies each chunk's MusicXML to
``temp/<split>/<v>/xml.xml``, calls the model with
``path_name='temp/<split>/<v>/'`` + ``composer=...``, and reads
``test_result/<v>_by_isgn_z0.mid``).

virtuosoNet is an *external* checkout (not vendored by the reference
either). This adapter encapsulates that contract behind the
``epr_generate(xml_path, composer) -> midi_path`` callable that
``data.render.xml_to_midi`` accepts, so ``midi_syn='epr'`` works whenever
a virtuosoNet checkout (with its pretrained isgn weights) is present, and
fails fast with instructions when it is not.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
from typing import Callable, Optional

_INSTALL_HELP = (
    "virtuosoNet checkout not found. midi_syn='epr' needs it for "
    "expressive-MIDI rendering:\n"
    "  git clone https://github.com/jdasam/virtuosoNet <dir>\n"
    "  (plus its pretrained isgn model weights)\n"
    "then point the adapter at it with one of:\n"
    "  * the VIRTUOSONET_PATH environment variable,\n"
    "  * a 'virtuosoNet' directory in the current directory or the "
    "workspace,\n"
    "  * prepare_data.py ... virtuosonet_path=<dir>\n"
    "or run with midi_syn='score' (verovio score-MIDI) instead.")


def find_virtuosonet(explicit: Optional[str] = None,
                     workspace: Optional[str] = None) -> Optional[str]:
    """Locate a virtuosoNet checkout; None if absent.

    Search order: explicit path, $VIRTUOSONET_PATH, ./virtuosoNet,
    <workspace>/virtuosoNet. A directory qualifies when it contains
    ``model_run.py`` (the module the reference imports).
    """
    if explicit:
        # An explicit path is authoritative: falling back to some other
        # checkout on a typo would silently render the dataset with the
        # wrong weights/version.
        if os.path.isfile(os.path.join(explicit, "model_run.py")):
            return os.path.abspath(explicit)
        raise RuntimeError(
            f"virtuosonet_path={explicit!r} is not a virtuosoNet checkout "
            "(no model_run.py there)")
    candidates = [os.environ.get("VIRTUOSONET_PATH"),
                  os.path.join(os.getcwd(), "virtuosoNet")]
    if workspace:
        candidates.append(os.path.join(workspace, "virtuosoNet"))
    for cand in candidates:
        if cand and os.path.isfile(os.path.join(cand, "model_run.py")):
            return os.path.abspath(cand)
    return None


@contextlib.contextmanager
def _inside(root: str):
    """chdir into the checkout (virtuosoNet resolves weights/temp files
    relative to its own directory), with cwd AND sys.path restored
    afterwards — a leaked sys.path[0] entry would shadow later bare
    imports with the checkout's generically-named modules."""
    prev = os.getcwd()
    os.chdir(root)
    added = root not in sys.path
    if added:
        sys.path.insert(0, root)
    try:
        yield
    finally:
        os.chdir(prev)
        if added:
            with contextlib.suppress(ValueError):
                sys.path.remove(root)


def make_epr_generator(root: Optional[str] = None,
                       workspace: Optional[str] = None,
                       model_code: str = "isgn") -> Callable[[str, str], str]:
    """Build ``epr_generate(xml_path, composer) -> midi_path``.

    Raises RuntimeError with install instructions when no checkout is
    found. The callable reproduces the reference's semantics: the score
    is staged as ``temp/epr/xml.xml`` inside the checkout, the model is
    invoked with its default latent (z=0) conditioned on ``composer``,
    and the rendered ``test_result/epr_by_<model>_z0.mid`` is returned.
    """
    found = find_virtuosonet(root, workspace)
    if found is None:
        raise RuntimeError(_INSTALL_HELP)

    # Load model_run by file path under a root-unique name: a bare
    # `import model_run` would be cached process-wide and pin the first
    # checkout ever seen. Sibling imports inside it resolve via the
    # sys.path entry _inside() adds.
    import importlib.util
    mod_name = f"_virtuosonet_model_run_{abs(hash(found)):x}"
    with _inside(found):
        spec = importlib.util.spec_from_file_location(
            mod_name, os.path.join(found, "model_run.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = module
        spec.loader.exec_module(module)
        load_file_and_generate_performance = \
            module.load_file_and_generate_performance

    stage_dir = os.path.join(found, "temp", "epr")
    result = os.path.join(found, "test_result", f"epr_by_{model_code}_z0.mid")

    def epr_generate(xml_path: str, composer: str) -> str:
        xml_abs = os.path.abspath(xml_path)
        with _inside(found):
            os.makedirs(stage_dir, exist_ok=True)
            shutil.copy(xml_abs, os.path.join(stage_dir, "xml.xml"))
            if os.path.exists(result):
                os.remove(result)  # never return a stale render
            # Keyword-only call, exactly the reference's invocation —
            # z stays at the model's default (0), giving the mean
            # composer-conditioned performance.
            load_file_and_generate_performance(
                path_name=os.path.join("temp", "epr") + os.sep,
                composer=composer)
        if not os.path.isfile(result):
            raise RuntimeError(
                f"virtuosoNet produced no output for {xml_path} "
                f"(expected {result})")
        return result

    return epr_generate
