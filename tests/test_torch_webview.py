"""tests/test_webview.py run against the port's copy of the web live view
(pedoni_tpu_torch/webview.py): the reference's fixture and tests, with the
names they read (WebViewer, loads_scenario) pointed at the port's for the
test's duration."""

import pytest

import test_webview as ref
from pedoni_tpu_torch import scenario, webview
from test_webview import viewer  # noqa: F401  (the reference's fixture)


@pytest.fixture(autouse=True)
def port_webview(monkeypatch):
    monkeypatch.setattr(ref, "WebViewer", webview.WebViewer)
    monkeypatch.setattr(ref, "loads_scenario", scenario.loads_scenario)


@pytest.mark.parametrize("name", ["test_scene_and_page",
                                  "test_state_wire_format_and_subsampling",
                                  "test_pause_control"])
def test_reference_webview_test_on_the_port(name, viewer):  # noqa: F811
    assert isinstance(viewer[0], webview.WebViewer)
    getattr(ref, name)(viewer)
