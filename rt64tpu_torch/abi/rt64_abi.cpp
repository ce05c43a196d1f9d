/*
 * rt64tpu_torch C ABI implementation: a thin native shim over the
 * Python core. Each exported RT64_* symbol (the reference's DLLEXPORT
 * set, scattered across rt64_device.cpp:1221-1246, rt64_view.cpp:
 * 2086-2201, etc.) acquires the GIL and forwards to
 * rt64tpu_torch.abi.bridge, passing POD struct POINTERS as integers; the
 * Python side parses them with ctypes.from_address, so the struct layout
 * is defined exactly once (in rt64_tpu.h, mirrored in bridge.py).
 *
 * The interpreter is embedded as the one that built this library: two
 * compile-time definitions, which rt64tpu_torch/abi/build.py passes,
 * name its executable (RT64TPU_TORCH_PYTHON: the embedded interpreter
 * takes its prefix, site-packages and sys.executable from it, not from
 * the host binary) and the repository root that holds the package
 * (RT64TPU_TORCH_ROOT, put first on sys.path).
 *
 * Error handling matches the reference contract: exceptions are caught
 * at the boundary, stored in a global last-error string, and surfaced
 * through RT64_GetLastError (rt64_common.h:365-383).
 */

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <mutex>
#include <string>

#include "rt64_tpu.h"

#if !defined(RT64TPU_TORCH_PYTHON) || !defined(RT64TPU_TORCH_ROOT)
#error "build with rt64tpu_torch/abi/build.py: it defines RT64TPU_TORCH_PYTHON and RT64TPU_TORCH_ROOT"
#endif

namespace {

std::string g_last_error;
std::mutex g_error_mutex;
PyObject *g_bridge = nullptr;

void set_last_error(const std::string &msg) {
    std::lock_guard<std::mutex> lock(g_error_mutex);
    g_last_error = msg;
}

void capture_py_error() {
    PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &value, &tb);
    std::string msg = "python error";
    if (value != nullptr) {
        PyObject *s = PyObject_Str(value);
        if (s != nullptr) {
            msg = PyUnicode_AsUTF8(s);
            Py_DECREF(s);
        }
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
    set_last_error(msg);
}

class Gil {
  public:
    Gil() : state_(PyGILState_Ensure()) {}
    ~Gil() { PyGILState_Release(state_); }

  private:
    PyGILState_STATE state_;
};

bool initialize_python() {
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    config.install_signal_handlers = 0;  /* the host owns its signals */
    PyStatus status = PyConfig_SetBytesString(&config, &config.executable,
                                              RT64TPU_TORCH_PYTHON);
    if (!PyStatus_Exception(status)) {
        status = Py_InitializeFromConfig(&config);
    }
    PyConfig_Clear(&config);
    if (PyStatus_Exception(status)) {
        set_last_error(std::string("Python failed to initialize: ") +
                       (status.err_msg != nullptr ? status.err_msg : "?"));
        return false;
    }
    /* Release the GIL taken by the initialization so Gil{} works
     * uniformly from any thread afterwards. */
    PyEval_SaveThread();
    return true;
}

bool ensure_bridge() {
    if (g_bridge != nullptr) {
        return true;
    }
    if (!Py_IsInitialized() && !initialize_python()) {
        return false;
    }
    Gil gil;
    PyObject *sys_path = PySys_GetObject("path");  /* borrowed */
    PyObject *root = PyUnicode_FromString(RT64TPU_TORCH_ROOT);
    if (sys_path == nullptr || root == nullptr ||
        PyList_Insert(sys_path, 0, root) != 0) {
        Py_XDECREF(root);
        capture_py_error();
        return false;
    }
    Py_DECREF(root);
    PyObject *mod = PyImport_ImportModule("rt64tpu_torch.abi.bridge");
    if (mod == nullptr) {
        capture_py_error();
        return false;
    }
    g_bridge = mod;
    return true;
}

/* Call bridge.<name>(args...) where every arg is an integer (pointer
 * or scalar). Returns the integer result (0 on void). */
uintptr_t call_bridge(const char *name, std::initializer_list<uintptr_t> args) {
    if (!ensure_bridge()) {
        return 0;
    }
    Gil gil;
    PyObject *fn = PyObject_GetAttrString(g_bridge, name);
    if (fn == nullptr) {
        capture_py_error();
        return 0;
    }
    PyObject *tuple = PyTuple_New(static_cast<Py_ssize_t>(args.size()));
    Py_ssize_t i = 0;
    for (uintptr_t a : args) {
        PyTuple_SET_ITEM(tuple, i++, PyLong_FromUnsignedLongLong(a));
    }
    PyObject *res = PyObject_CallObject(fn, tuple);
    Py_DECREF(tuple);
    Py_DECREF(fn);
    if (res == nullptr) {
        capture_py_error();
        return 0;
    }
    uintptr_t out = 0;
    if (res != Py_None) {
        out = static_cast<uintptr_t>(PyLong_AsUnsignedLongLong(res));
        if (PyErr_Occurred()) {
            capture_py_error();
            out = 0;
        }
    }
    Py_DECREF(res);
    return out;
}

template <typename T>
uintptr_t ptr(T *p) {
    return reinterpret_cast<uintptr_t>(p);
}

}  // namespace

extern "C" {

const char *RT64_GetLastError(void) {
    std::lock_guard<std::mutex> lock(g_error_mutex);
    return g_last_error.c_str();
}

RT64_DEVICE *RT64_CreateDevice(void *window) {
    return reinterpret_cast<RT64_DEVICE *>(
        call_bridge("create_device", {ptr(window)}));
}

void RT64_DestroyDevice(RT64_DEVICE *device) {
    call_bridge("destroy_device", {ptr(device)});
}

void RT64_DrawDevice(RT64_DEVICE *device, int vsyncInterval, float deltaTimeMs) {
    call_bridge("draw_device",
                {ptr(device), static_cast<uintptr_t>(vsyncInterval),
                 static_cast<uintptr_t>(deltaTimeMs * 1000.0f)});
}

RT64_VIEW *RT64_CreateView(RT64_SCENE *scene) {
    return reinterpret_cast<RT64_VIEW *>(call_bridge("create_view", {ptr(scene)}));
}

void RT64_SetViewPerspective(RT64_VIEW *view, RT64_MATRIX4 viewMatrix,
                             float fovRadians, float nearDist, float farDist,
                             bool canReproject) {
    /* Pass by address of the stack copy; the bridge copies synchronously. */
    float params[3] = {fovRadians, nearDist, farDist};
    call_bridge("set_view_perspective",
                {ptr(view), ptr(&viewMatrix), ptr(&params[0]),
                 static_cast<uintptr_t>(canReproject ? 1 : 0)});
}

void RT64_SetViewDescription(RT64_VIEW *view, RT64_VIEW_DESC viewDesc) {
    call_bridge("set_view_description", {ptr(view), ptr(&viewDesc)});
}

void RT64_SetViewSkyPlane(RT64_VIEW *view, RT64_TEXTURE *texture) {
    call_bridge("set_view_sky_plane", {ptr(view), ptr(texture)});
}

RT64_INSTANCE *RT64_GetViewRaytracedInstanceAt(RT64_VIEW *view, int x, int y) {
    return reinterpret_cast<RT64_INSTANCE *>(call_bridge(
        "get_view_raytraced_instance_at",
        {ptr(view), static_cast<uintptr_t>(x), static_cast<uintptr_t>(y)}));
}

bool RT64_GetViewUpscalerSupport(RT64_VIEW *view, char upscaler) {
    return call_bridge("get_view_upscaler_support",
                       {ptr(view), static_cast<uintptr_t>(upscaler)}) != 0;
}

void RT64_DestroyView(RT64_VIEW *view) { call_bridge("destroy_view", {ptr(view)}); }

RT64_SCENE *RT64_CreateScene(RT64_DEVICE *device) {
    return reinterpret_cast<RT64_SCENE *>(call_bridge("create_scene", {ptr(device)}));
}

void RT64_SetSceneDescription(RT64_SCENE *scene, RT64_SCENE_DESC sceneDesc) {
    call_bridge("set_scene_description", {ptr(scene), ptr(&sceneDesc)});
}

void RT64_SetSceneLights(RT64_SCENE *scene, RT64_LIGHT *lightArray, int lightCount) {
    call_bridge("set_scene_lights",
                {ptr(scene), ptr(lightArray), static_cast<uintptr_t>(lightCount)});
}

void RT64_DestroyScene(RT64_SCENE *scene) { call_bridge("destroy_scene", {ptr(scene)}); }

RT64_MESH *RT64_CreateMesh(RT64_DEVICE *device, int flags) {
    return reinterpret_cast<RT64_MESH *>(
        call_bridge("create_mesh", {ptr(device), static_cast<uintptr_t>(flags)}));
}

void RT64_SetMesh(RT64_MESH *mesh, void *vertexArray, int vertexCount,
                  int vertexStride, unsigned int *indexArray, int indexCount) {
    call_bridge("set_mesh",
                {ptr(mesh), ptr(vertexArray), static_cast<uintptr_t>(vertexCount),
                 static_cast<uintptr_t>(vertexStride), ptr(indexArray),
                 static_cast<uintptr_t>(indexCount)});
}

void RT64_DestroyMesh(RT64_MESH *mesh) { call_bridge("destroy_mesh", {ptr(mesh)}); }

RT64_SHADER *RT64_CreateShader(RT64_DEVICE *device, unsigned int shaderId,
                               unsigned int filter, unsigned int hAddr,
                               unsigned int vAddr, int flags) {
    return reinterpret_cast<RT64_SHADER *>(call_bridge(
        "create_shader",
        {ptr(device), static_cast<uintptr_t>(shaderId), static_cast<uintptr_t>(filter),
         static_cast<uintptr_t>(hAddr), static_cast<uintptr_t>(vAddr),
         static_cast<uintptr_t>(flags)}));
}

void RT64_DestroyShader(RT64_SHADER *shader) {
    call_bridge("destroy_shader", {ptr(shader)});
}

RT64_INSTANCE *RT64_CreateInstance(RT64_SCENE *scene) {
    return reinterpret_cast<RT64_INSTANCE *>(
        call_bridge("create_instance", {ptr(scene)}));
}

void RT64_SetInstanceDescription(RT64_INSTANCE *instance,
                                 RT64_INSTANCE_DESC instanceDesc) {
    call_bridge("set_instance_description", {ptr(instance), ptr(&instanceDesc)});
}

void RT64_DestroyInstance(RT64_INSTANCE *instance) {
    call_bridge("destroy_instance", {ptr(instance)});
}

void RT64_SetInstanceAltTexture(RT64_INSTANCE *instance,
                                RT64_TEXTURE *texture) {
    call_bridge("set_instance_alt_texture", {ptr(instance), ptr(texture)});
}

RT64_TEXTURE *RT64_CreateTexture(RT64_DEVICE *device, RT64_TEXTURE_DESC desc) {
    return reinterpret_cast<RT64_TEXTURE *>(
        call_bridge("create_texture", {ptr(device), ptr(&desc)}));
}

void RT64_DestroyTexture(RT64_TEXTURE *texture) {
    call_bridge("destroy_texture", {ptr(texture)});
}

RT64_INSPECTOR *RT64_CreateInspector(RT64_DEVICE *device) {
    return reinterpret_cast<RT64_INSPECTOR *>(
        call_bridge("create_inspector", {ptr(device)}));
}

bool RT64_HandleMessageInspector(RT64_INSPECTOR *inspector, unsigned int msg,
                                 unsigned long wParam, long lParam) {
    return call_bridge("handle_message_inspector",
                       {ptr(inspector), static_cast<uintptr_t>(msg),
                        static_cast<uintptr_t>(wParam),
                        static_cast<uintptr_t>(lParam)}) != 0;
}

void RT64_SetSceneInspector(RT64_INSPECTOR *inspector, RT64_SCENE_DESC *sceneDesc) {
    call_bridge("set_scene_inspector", {ptr(inspector), ptr(sceneDesc)});
}

void RT64_SetMaterialInspector(RT64_INSPECTOR *inspector, RT64_MATERIAL *material,
                               const char *materialName) {
    call_bridge("set_material_inspector",
                {ptr(inspector), ptr(material), ptr(materialName)});
}

void RT64_SetLightsInspector(RT64_INSPECTOR *inspector, RT64_LIGHT *lights,
                             int *lightCount, int maxLightCount) {
    call_bridge("set_lights_inspector",
                {ptr(inspector), ptr(lights), ptr(lightCount),
                 static_cast<uintptr_t>(maxLightCount)});
}

void RT64_PrintClearInspector(RT64_INSPECTOR *inspector) {
    call_bridge("print_clear_inspector", {ptr(inspector)});
}

void RT64_PrintMessageInspector(RT64_INSPECTOR *inspector, const char *message) {
    call_bridge("print_message_inspector", {ptr(inspector), ptr(message)});
}

void RT64_DestroyInspector(RT64_INSPECTOR *inspector) {
    call_bridge("destroy_inspector", {ptr(inspector)});
}

void RT64_GetViewFrameSize(RT64_VIEW *view, int *width, int *height) {
    call_bridge("get_view_frame_size", {ptr(view), ptr(width), ptr(height)});
}

bool RT64_GetViewFramePixels(RT64_VIEW *view, void *dst, size_t dstSize) {
    return call_bridge("get_view_frame_pixels",
                       {ptr(view), ptr(dst), static_cast<uintptr_t>(dstSize)}) != 0;
}

}  // extern "C"
